"""The port's learning-rate schedules (``torecsys_tpu_torch/train/schedules.py``)
against optax's, and a schedule as ``learning_rate``.

* Each of optax's fourteen schedules, under its own arguments, at counts 0 to
  60 on an int32 count tensor, against the jitted optax schedule on an int32
  count (as a jitted optax update evaluates it): within 4e-6 of the
  schedule's largest value (float32 operations in optax's order; XLA fuses
  some of them).
* A schedule as ``learning_rate`` of a written-out optimizer: 5 steps
  against jitted optax, each step at its own rate (the count lives on the
  parameters' device); the dense route's Trainer under a schedule against
  the JAX Trainer; on the sparse route both Trainers raise ``TypeError`` at
  the first step, as the JAX row optimizer takes ``jnp.float32(lr)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torecsys_tpu_torch.train import schedules as S

CASES = {
    "constant_schedule": dict(value=0.3),
    "linear_schedule": dict(init_value=1e-3, end_value=1e-5, transition_steps=17,
                            transition_begin=3),
    "polynomial_schedule": dict(init_value=1e-2, end_value=1e-4, power=2.5,
                                transition_steps=20, transition_begin=2),
    "exponential_decay": dict(init_value=1e-2, transition_steps=7, decay_rate=0.5,
                              transition_begin=3, staircase=True, end_value=1e-4),
    "cosine_decay_schedule": dict(init_value=1e-2, decay_steps=23, alpha=0.1, exponent=2.0),
    "piecewise_constant_schedule": dict(init_value=1e-2, boundaries_and_scales={5: 0.5,
                                                                                12: 0.1}),
    "piecewise_interpolate_schedule": dict(interpolate_type="cosine", init_value=1e-2,
                                           boundaries_and_scales={5: 0.5, 12: 0.1}),
    "join_schedules": None,
    "warmup_constant_schedule": dict(init_value=0.0, peak_value=1e-2, warmup_steps=6),
    "warmup_cosine_decay_schedule": dict(init_value=0.0, peak_value=1e-2, warmup_steps=6,
                                         decay_steps=30, end_value=1e-4),
    "warmup_exponential_decay_schedule": dict(init_value=0.0, peak_value=1e-2,
                                              warmup_steps=6, transition_steps=5,
                                              decay_rate=0.7),
    "sgdr_schedule": dict(cosine_kwargs=[
        dict(init_value=0.0, peak_value=1e-2, warmup_steps=3, decay_steps=10),
        dict(init_value=1e-3, peak_value=5e-3, warmup_steps=2, decay_steps=12)]),
    "linear_onecycle_schedule": dict(transition_steps=40, peak_value=1e-2),
    "cosine_onecycle_schedule": dict(transition_steps=40, peak_value=1e-2),
}


def both(name):
    if name == "join_schedules":
        return (optax.join_schedules([optax.linear_schedule(0.0, 1e-2, 8),
                                      optax.exponential_decay(1e-2, 4, 0.8)], [8]),
                S.join_schedules([S.linear_schedule(0.0, 1e-2, 8),
                                  S.exponential_decay(1e-2, 4, 0.8)], [8]))
    return getattr(optax, name)(**CASES[name]), getattr(S, name)(**CASES[name])


@pytest.mark.parametrize("name", list(CASES))
def test_schedule_matches_jitted_optax(name):
    ref, port = both(name)
    want = np.array([jax.jit(ref)(jnp.int32(c)) for c in range(61)], np.float32)
    got = np.array([port(torch.tensor(c, dtype=torch.int32)).item() for c in range(61)],
                   np.float32)
    if name == "polynomial_schedule":
        # jitted optax's NaN at the end of a fractional power (schedules.py)
        nan = np.isnan(want)
        assert nan[-1] and (got[nan] == np.float32(CASES[name]["end_value"])).all()
        want, got = want[~nan], got[~nan]
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-6 * np.abs(want).max())
    assert port(7).dtype == torch.float32  # a Python int count too
    np.testing.assert_allclose(port(7).item(), want[7], rtol=0, atol=4e-6 * np.abs(want).max())


def test_schedules_refuse_what_optax_refuses():
    for name, kwargs in (("cosine_decay_schedule", dict(init_value=1.0, decay_steps=0)),
                         ("linear_onecycle_schedule", dict(transition_steps=0, peak_value=1)),
                         ("piecewise_constant_schedule", dict(init_value=1.0,
                                                              boundaries_and_scales={3: -1})),
                         ("piecewise_interpolate_schedule", dict(interpolate_type="cubic",
                                                                 init_value=1.0))):
        with pytest.raises(ValueError):
            getattr(optax, name)(**kwargs)
        with pytest.raises(ValueError):
            getattr(S, name)(**kwargs)


@pytest.mark.parametrize("name", ["adam", "adamw", "lion", "sgd", "adabelief", "fromage",
                                  "adafactor", "noisy_sgd"])
def test_a_schedule_as_learning_rate_over_five_steps(name):
    """Each update takes the schedule at its own count, 0 first, as optax's
    ``scale_by_schedule``; the count is a device tensor of the optimizer's
    state."""
    from test_torch_optimizers import as_port, grads, jax_steps, leaves, port_state, set_grads

    from torecsys_tpu_torch.convert import flatten, torch_name

    kw = dict(init_value=1e-3, peak_value=2e-2, warmup_steps=2, decay_steps=6)
    tx = getattr(optax, name)(learning_rate=optax.warmup_cosine_decay_schedule(**kw))
    if name == "noisy_sgd":
        tx = optax.sgd(optax.warmup_cosine_decay_schedule(**kw))  # the noise is held apart
    want, _ = jax_steps(tx, jax.tree.map(jnp.asarray, leaves(1)), 5, seed=20)
    sched = S.warmup_cosine_decay_schedule(**kw)
    kwargs = {"eta": 0.0} if name == "noisy_sgd" else {}
    module, port = port_state(name, {"learning_rate": sched, **kwargs}, leaves(1), None)
    for i in range(5):
        set_grads(module, grads(20 + i))
        port.opt_state.step()
    counts = {int(s["lr_count"]) for s in port.opt_state.state.values()}
    assert counts == {5}
    named = dict(module.named_parameters())
    for path, ref in flatten(jax.device_get(want)).items():
        np.testing.assert_allclose(named[torch_name(path)].detach().numpy(), as_port(path, ref),
                                   rtol=1e-5, atol=1e-7, err_msg=path)


def test_schedule_on_the_dense_route_and_refused_on_the_sparse_route():
    """The dense route's Trainer under ``warmup_cosine_decay_schedule`` tracks
    the JAX Trainer's (losses rtol 1e-5); on the sparse route the JAX
    package's row optimizer takes ``jnp.float32(learning_rate)`` and its
    first step raises ``TypeError``, and so does the port's."""
    from test_torch_field_aware import batches, schema

    from torecsys_tpu import inputs as J
    from torecsys_tpu.train import Pipeline as JaxPipeline
    from torecsys_tpu.train import Trainer as JaxTrainer
    from torecsys_tpu_torch import Pipeline, Trainer
    from torecsys_tpu_torch import inputs as T
    from torecsys_tpu_torch.convert import from_flax_params

    kw = dict(init_value=1e-4, peak_value=1e-2, warmup_steps=2, decay_steps=8)
    feed = batches(5)
    for sparse in (False, True):
        jp = (JaxPipeline().set_objective("ctr").set_inputs(J.Inputs(schema=schema("fused", J)))
              .set_model("DeepFM", deep_layer_sizes=(8,)).set_criterion("BCEWithLogitsLoss")
              .set_optimizer("Adam", lr=optax.warmup_cosine_decay_schedule(**kw))
              .set_sparse_embeddings(sparse).set_target_fields("label"))
        jt = JaxTrainer(jp, presort=False, prefetch=0, seed=0)
        jt.init_state(feed[0])
        jt._build_steps()
        pipe = (Pipeline(device="cpu").set_objective("ctr")
                .set_inputs(T.Inputs(schema("fused", T)))
                .set_model("DeepFM", deep_layer_sizes=(8,)).set_criterion("BCEWithLogitsLoss")
                .set_optimizer("Adam", lr=S.warmup_cosine_decay_schedule(**kw))
                .set_sparse_embeddings(sparse).set_target_fields("label"))
        port = Trainer(pipe, presort=False, prefetch=0)
        port.init_state()
        from_flax_params(pipe.sequential, jax.device_get(jt.state.params))

        def jax_step(batch):
            with jt._trace_contexts():
                jt.state, logs = jt._train_step_fn(jt.state, jt._place_batch(batch))
            return float(logs["loss"])

        if sparse:
            with pytest.raises(TypeError):
                jax_step(feed[0])
            with pytest.raises(TypeError):
                port.train_steps(feed[:1])
            continue
        want = [jax_step(b) for b in feed]
        got = [float(v) for v in port.train_steps(feed)]
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("name,kwargs", [
    ("Adam", {"lr": "schedule"}), ("adamw", {"lr": 1e-3, "mu_dtype": torch.bfloat16,
                                             "mask": lambda t: {k: True for k in t}}),
    ("noisy_sgd", {"lr": 1e-2, "key": 3}), ("sm3", {"lr": 1e-2})],
    ids=["schedule", "mask-mu_dtype", "noisy_sgd", "sm3"])
def test_a_checkpoint_resumes_a_schedule_and_the_new_state(name, kwargs, tmp_path):
    """A checkpoint keeps the schedule's count (the schedule itself stays the
    live one), a mask's groups, a narrow moment and per-axis state: a
    trainer resumed from it takes the same next step as the one that wrote
    it."""
    from test_torch_field_aware import batches, schema

    from torecsys_tpu_torch import Pipeline, Trainer
    from torecsys_tpu_torch import inputs as T

    if kwargs.get("lr") == "schedule":
        kwargs = {"lr": S.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 8)}
    feed = batches(4)

    def make():
        pipe = (Pipeline(device="cpu").set_inputs(T.Inputs(schema("fused", T)))
                .set_model("DeepFM", deep_layer_sizes=(8,)).set_optimizer(name, **kwargs)
                .set_sparse_embeddings(False).set_target_fields("label"))
        return Trainer(pipe, checkpoint_dir=str(tmp_path), seed=1, prefetch=0)

    first = make()
    first.fit(feed[:3], max_epochs=1)
    resumed = make()
    resumed.init_state()
    assert int(resumed.state.step) == 3
    assert first.train_steps(feed[3:])[0].item() == resumed.train_steps(feed[3:])[0].item()
