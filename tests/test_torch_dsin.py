"""DSIN and the sequence inputs through the port's pipeline and Trainer,
against the JAX package from the same flax parameters.

Tolerances: DSIN's forward at float32 within rtol 1e-5 (atol 1e-6 of the
largest output); under bf16 against the jitted JAX model (see
``test_dsin_forward_under_bf16_matches_the_jitted_jax_model``); the
Trainers' losses within rtol 1e-5; after a sixth step from the JAX
Trainer's state every parameter within atol 1e-6 and the optimizer state
and row slots within rtol 1e-5 / atol 1e-6, but the parameters whose
gradient is 0 in exact arithmetic (an attention's key bias: it moves each
query's scores alike), which are held as gradients, at the noise.

* DSIN's forward in training and eval mode, with and without its output
  head and its bias encoding; bf16 compute.
* ``get_model("DSIN", ...)`` builds as the JAX ``get_model`` does, with the
  ``FutureWarning``; the registry's names.
* The Trainer: DSIN over a ``ListIndicesEmbedding(output_method="none")``
  and the raw session index on the dense route; DeepFM over a mixed
  ``StackedInput`` (a fused table, a 2-layer bidirectional LSTM sequence
  input with a lengths field, a list input with attention) on the
  presorted, on-device and dense routes: the fused table on the sparse
  route's row rule, the two history tables on the dense optimizer.
* Two steps a dispatch (the packed groups carry the ``(B, L)`` ids and the
  ``(B,)`` lengths) equal single steps to the bit, with the prefetch
  workers; evaluate and predict; the CLI builds both inputs from JSON.
"""

import re
import warnings

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_field_aware import CATS, DENSE, FIELDS, ROUTES, STEPS, batches
from test_torch_optim_train import assert_opt_state_close

import torecsys_tpu.models as JM
from torecsys_tpu import inputs as J
from torecsys_tpu.layers.precision import use_compute_dtype
from torecsys_tpu.models.base import get_model as jax_get_model
from torecsys_tpu.train import Pipeline as JaxPipeline
from torecsys_tpu.train import Trainer as JaxTrainer
from torecsys_tpu_torch import inputs as T
from torecsys_tpu_torch import Pipeline, Trainer
from torecsys_tpu_torch.cli import _build_inputs
from torecsys_tpu_torch.convert import flatten, from_flax_params, torch_name
from torecsys_tpu_torch.layers.precision import apply_compute_dtype
from torecsys_tpu_torch.models import MODELS, get_model
from torecsys_tpu_torch.train.sparse import sparse_modules

B, L, E, H, V, SESSIONS = 64, 6, 8, 4, 40, 4
DSIN_KWARGS = {"embed_size": E, "max_num_session": SESSIONS, "max_num_position": L,
               "extractor_num_heads": 2, "interacting_hidden_size": H}
LR = 1e-2
# an attention's key bias: its gradient is 0 in exact arithmetic
DEAD = re.compile(r"(^|/)(interest_extractor|MultiHeadDotProductAttention_0)/key/bias$")


def _draw(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _randomize(tree, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32) + rng.normal(size=np.shape(a)) * scale).astype(
            np.float32), tree)


def _close(got, want, rtol=1e-5):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * np.abs(want).max())


# ---- the model alone -----------------------------------------------------------------

def _dsin_pair(seed=0, **overrides):
    kwargs = {**DSIN_KWARGS, **overrides}
    x = _draw(4, L, E, seed=seed)
    idx = np.array([0, 3, 1, 2], np.int32)
    jm = JM.DSIN(**kwargs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        params = _randomize(jm.init(jax.random.key(seed), x, idx)["params"], seed + 1)
        port = from_flax_params(get_model("DSIN", device="cpu", **kwargs), params)
    assert set(dict(port.named_parameters())) == {torch_name(p) for p in flatten(params)}
    return jm, port, params, x, idx


@pytest.mark.parametrize("variant", ["head", "features", "no_bias_encoding"])
def test_dsin_forward_matches_the_jax_model(variant):
    overrides = {"features": {"use_output_head": False},
                 "no_bias_encoding": {"use_bias_encoding": False}}.get(variant, {})
    jm, port, params, x, idx = _dsin_pair(**overrides)
    args = (torch.from_numpy(x), torch.from_numpy(idx))
    want = jm.apply({"params": params}, x, idx)
    assert want.shape == ((4, E + 2 * H) if variant == "features" else (4, 1))
    port.train()
    _close(port(*args), want)
    port.eval()
    _close(port(*args), want)


def test_dsin_forward_under_bf16_matches_the_jitted_jax_model():
    """The extractor and the head in bf16, the cells in float32 on the bf16
    extraction (flax promotes it): the bf16 output within one bf16 ulp of
    the largest output.  Not to the bit: the cells' float32 products sum in
    torch's order on one side and XLA's on the other, and a last-bit
    difference there can move the head's bf16 rounding by one ulp."""
    jm, port, params, x, idx = _dsin_pair(seed=5)
    apply_compute_dtype(port, "bfloat16")
    assert port.interest_extractor.compute_dtype == torch.bfloat16
    assert port.output_head.compute_dtype == torch.bfloat16
    with use_compute_dtype("bfloat16"):
        want = jax.jit(lambda p, a, i: jm.apply({"params": p}, a, i))(params, x, idx)
    got = port.eval()(torch.from_numpy(x), torch.from_numpy(idx))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    w = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().detach().numpy(), w, rtol=0,
                               atol=2.0 ** -8 * np.abs(w).max())


def test_dsin_builds_as_the_jax_get_model_builds_it():
    for name in ("DSIN", "DeepSessionInterestNetwork", "DeepSessionInterestNetworkModel"):
        assert MODELS[name] is MODELS["DSIN"]
        with pytest.warns(FutureWarning, match="in development"):
            port = get_model(name, device="cpu", **DSIN_KWARGS)
        with pytest.warns(FutureWarning, match="in development"):
            jm = jax_get_model(name, **DSIN_KWARGS)
        assert type(port).__name__ == type(jm).__name__ == "DeepSessionInterestNetworkModel"
    # the port reads E off the session input where it is not given
    inputs = T.Inputs({"session_embed_inputs": T.ListIndicesEmbedding(
        V, E, ("behaviour",), output_method="none", device="cpu"),
        "session_index": SessionIndex()})
    kwargs = {k: v for k, v in DSIN_KWARGS.items() if k != "embed_size"}
    with pytest.warns(FutureWarning):
        built = get_model("DSIN", inputs=inputs, device="cpu", **kwargs)
    assert built.output_head.in_features == E + 2 * H


# ---- through the Trainer ---------------------------------------------------------------

class SessionIndex(T.BaseInput):
    """The raw ``(B,)`` session index."""

    fields = ("session",)

    def forward(self, batch):
        return batch["session"]


class JaxSessionIndex(fnn.Module):
    def __call__(self, batch, training=False):
        return batch["session"]


def _histories(feed, seed=0):
    """Add to each batch the behaviour ids ``(B, L)`` (padding 0 past random
    lengths 0..L, a row of padding throughout among them), their
    ``behaviour_len``, a second history and the session index."""
    rng = np.random.default_rng(seed)
    for b in feed:
        for name in ("behaviour", "clicks"):
            lengths = rng.integers(0, L + 1, B).astype(np.int32)
            lengths[0] = 0
            ids = rng.integers(1, V, (B, L)).astype(np.int32)
            ids[np.arange(L)[None, :] >= lengths[:, None]] = 0
            b[name], b[f"{name}_len"] = ids, lengths
        b["session"] = rng.integers(0, SESSIONS, B).astype(np.int32)
    return feed


def _dsin_schema(port):
    if port:
        return {"session_embed_inputs": T.ListIndicesEmbedding(
            V, E, ("behaviour",), output_method="none", device="cpu"),
            "session_index": SessionIndex()}
    return {"session_embed_inputs": J.ListIndicesEmbedding(
        field_size=V, embed_size=E, fields=("behaviour",), output_method="none"),
        "session_index": JaxSessionIndex()}


def _mixed_schema(port):
    """DeepFM's inputs: dense values, and a fused table stacked with a
    bidirectional 2-layer LSTM sequence input (lengths field) and a list
    input with attention."""
    seq_kw = {"lengths_field": "behaviour_len", "rnn_method": "lstm", "bidirectional": True,
              "num_layers": 2, "output_method": "avg_pooling"}
    lst_kw = {"use_attn": True, "num_heads": 2}
    if port:
        children = [T.MultiIndicesEmbedding(E, FIELDS, CATS, device="cpu"),
                    T.SequenceIndicesEmbedding(V, E, ("behaviour",), device="cpu", **seq_kw),
                    T.ListIndicesEmbedding(V, E, ("clicks",), device="cpu", **lst_kw)]
        return {"feat_inputs": T.ValueInput(DENSE), "emb_inputs": T.StackedInput(children)}
    children = (J.MultiIndicesEmbedding(embed_size=E, field_sizes=FIELDS, fields=CATS),
                J.SequenceIndicesEmbedding(field_size=V, embed_size=E, fields=("behaviour",),
                                           **seq_kw),
                J.ListIndicesEmbedding(field_size=V, embed_size=E, fields=("clicks",), **lst_kw))
    return {"feat_inputs": J.ValueInput(fields=DENSE), "emb_inputs": J.StackedInput(
        inputs=children)}


CASES = {"dsin": (_dsin_schema, "DSIN", DSIN_KWARGS, "BCEWithLogitsLoss"),
         "mixed_deepfm": (_mixed_schema, "DeepFM", {"deep_layer_sizes": (16,)},
                          "BCEWithLogitsLoss")}


def _pipelines(case, sparse):
    make, model, kwargs, crit = CASES[case]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        jpipe = (JaxPipeline().set_objective("ctr").set_inputs(J.Inputs(schema=make(False)))
                 .set_model(model, **kwargs).set_criterion(crit).set_optimizer("Adam", lr=LR)
                 .set_sparse_embeddings(sparse).set_target_fields("label"))
        pipe = (Pipeline(device="cpu").set_objective("ctr").set_inputs(T.Inputs(make(True)))
                .set_model(model, **kwargs).set_criterion(crit).set_optimizer("Adam", lr=LR)
                .set_sparse_embeddings(sparse).set_target_fields("label"))
    return jpipe, pipe


class JaxRun:
    def __init__(self, pipe, route, feed):
        self.t = JaxTrainer(pipe, presort=route.presort, prefetch=0, seed=0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            self.t.init_state(feed[0])
        self.t._setup_presorter()
        self.t._build_steps()

    def step(self, batch):
        if self.t._presorter is not None:
            batch = self.t._presorter(batch)
        with self.t._trace_contexts():
            self.t.state, logs = self.t._train_step_fn(self.t.state, self.t._place_batch(batch))
        return float(logs["loss"])

    def params(self):
        return jax.device_get(self.t.state.params)

    def opt_state(self):
        return jax.device_get(self.t.state.opt_state)

    def grads(self, batch):
        """The loss gradient at the state, by flax path."""
        seq, crit = self.t.pipeline.sequential, self.t.pipeline.criterion
        features = {k: v for k, v in batch.items() if k != "label"}

        def loss(params):
            return crit(seq.apply({"params": params}, features, training=True), batch["label"])

        return flatten(jax.device_get(jax.grad(loss)(self.t.state.params)))


def _port_trainer(case, route, params, **kwargs):
    _, pipe = _pipelines(case, route.sparse)
    trainer = Trainer(pipe, presort=route.presort, prefetch=0, **kwargs)
    trainer.init_state()
    from_flax_params(pipe.sequential, params)
    return trainer


def _port_grads(trainer, batch):
    seq = trainer.pipeline.sequential
    seq.train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    label = tb.pop("label")
    loss = trainer.pipeline.criterion(seq(tb), label)
    named = dict(seq.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()), allow_unused=True)))
    # a sparse-route table is held by its value after the step
    for name in sparse_modules(seq) if trainer.sparse else ():
        grads.pop(name)
    return grads


@pytest.mark.parametrize("case,route_name", [("dsin", "dense"), ("mixed_deepfm", "presorted"),
                                             ("mixed_deepfm", "ondevice"),
                                             ("mixed_deepfm", "dense")])
def test_trainer_matches_the_jax_trainer(case, route_name, monkeypatch):
    route = ROUTES[route_name]
    monkeypatch.setenv("TORECSYS_TPU_FUSED_DEDUP", route.fused)
    feed = _histories(batches(STEPS + 1, seed=7), seed=8)
    jpipe, _ = _pipelines(case, route.sparse)
    ref = JaxRun(jpipe, route, feed)
    port = _port_trainer(case, route, ref.params())
    assert port.sparse == route.sparse
    tables = set(sparse_modules(port.pipeline.sequential))
    if route.sparse:
        # the fused table alone is on the row rule; the history tables are not
        assert tables == {"inputs.schema.emb_inputs.inputs.0.embedding"}
        assert set(port.state.opt_state["sparse"]) == tables
    want = [ref.step(b) for b in feed[:STEPS]]
    got = [float(x) for x in port.train_steps(feed[:STEPS])]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # one step from the JAX Trainer's state
    port = _port_trainer(case, route, ref.params())
    from_flax_params(port.pipeline.sequential, ref.params(), ref.opt_state(), port.state,
                     step=int(ref.t.state.step))
    last = feed[STEPS]
    grads, jgrads = _port_grads(port, last), ref.grads(last)
    largest = max(float(np.abs(g).max()) for g in jgrads.values())
    dead = [p for p in jgrads if DEAD.search(p)]
    assert len(dead) == 1
    for path, jg in jgrads.items():
        if torch_name(path) not in grads:
            continue  # the sparse route's table: held by its value after the step
        g, jg = grads[torch_name(path)].numpy(), np.asarray(jg)
        jg = jg.T if path.endswith("kernel") else jg
        if path in dead:
            assert np.abs(g).max() <= 1e-6 * largest and np.abs(jg).max() <= 1e-6 * largest
            continue
        np.testing.assert_allclose(g, jg, rtol=1e-3, atol=1e-6 * largest, err_msg=path)
    np.testing.assert_allclose(float(port.train_steps([last])[0]), ref.step(last), rtol=1e-5)
    named = dict(port.pipeline.sequential.named_parameters())
    for path, want_p in flatten(ref.params()).items():
        if path in dead:
            continue
        want_p = np.asarray(want_p)
        np.testing.assert_allclose(named[torch_name(path)].detach().numpy(),
                                   want_p.T if path.endswith("kernel") else want_p, rtol=0,
                                   atol=1e-6, err_msg=path)
    assert_opt_state_close(port, ref)


def test_sequence_tables_stay_on_the_dense_optimizer_on_the_sparse_route():
    """On a mixed ``StackedInput`` the sparse route's row rule takes the
    fused table alone; the two history tables are dense parameters, with
    Adam moments, as in the JAX package (its presort gives them no spec)."""
    _, pipe = _pipelines("mixed_deepfm", True)
    trainer = Trainer(pipe, presort=True, prefetch=0)
    trainer.init_state()
    feed = _histories(batches(2, seed=9), seed=10)
    trainer.train_steps(feed)
    seq = pipe.sequential
    assert list(sparse_modules(seq)) == ["inputs.schema.emb_inputs.inputs.0.embedding"]
    dense = trainer.state.opt_state["dense"]
    for i in (1, 2):
        table = seq.inputs.schema["emb_inputs"].inputs[i].embedding
        assert not isinstance(seq.inputs.schema["emb_inputs"].inputs[i], T.TableInput)
        assert set(dense.state[table]) == {"step", "exp_avg", "exp_avg_sq"}
        assert dense.state[table]["exp_avg"].abs().max() > 0
    # the presort sorts the fused table's ids alone
    assert [spec.slot_fields for spec in trainer._presorter.specs] == [CATS]


@pytest.mark.parametrize("case", ["dsin", "mixed_deepfm"])
def test_two_steps_a_dispatch_carry_the_histories(case):
    """The packed groups hold the ``(B, L)`` ids and the ``(B,)`` lengths:
    two steps a dispatch, with the prefetch workers (presorted route), equal
    single steps to the bit; evaluate and predict run."""
    feed = _histories(batches(4, seed=11), seed=12)
    sparse = case == "mixed_deepfm"
    runs = []
    for spe in (1, 2):
        _, pipe = _pipelines(case, sparse)
        pipe.sequential.reset_parameters(torch.Generator().manual_seed(0))
        trainer = Trainer(pipe, presort=True if sparse else None, prefetch=2,
                          steps_per_execution=spe)
        trainer.init_state()
        losses = [float(x) for x in trainer.train_steps(feed)]
        runs.append((losses, {n: p.detach().clone()
                              for n, p in pipe.sequential.named_parameters()}))
    assert runs[0][0] == runs[1][0]
    for name, value in runs[0][1].items():
        assert torch.equal(value, runs[1][1][name]), name
    metrics = trainer.evaluate(feed[:2])
    assert all(np.isfinite(v) for v in metrics.values())
    assert tuple(trainer.predict(feed[0]).shape) == (B, 1)


def test_cli_builds_both_sequence_inputs_from_json():
    inputs = _build_inputs({
        "emb_inputs": {"method": "StackedInput", "inputs": [
            {"method": "MultiIndicesEmbedding", "embed_size": 4, "field_sizes": [10, 20],
             "fields": ["a", "b"]},
            {"method": "SequenceIndicesEmbedding", "embed_size": 4, "field_size": 9,
             "fields": ["h"], "rnn_method": "gru", "bidirectional": True, "num_layers": 2,
             "lengths_field": "h_len"},
            {"method": "ListIndicesEmbedding", "embed_size": 4, "field_size": 9,
             "fields": ["l"], "use_attn": True, "num_heads": 2, "output_method": "max_pooling"}]},
        "seq_inputs": {"method": "ListIndicesEmbedding", "embed_size": 4, "field_size": 9,
                       "fields": ["l"], "output_method": "none"}}, "cpu")
    stacked = inputs.schema["emb_inputs"]
    assert [type(m).__name__ for m in stacked.inputs] == [
        "MultiIndicesEmbedding", "SequenceIndicesEmbedding", "ListIndicesEmbedding"]
    assert stacked.inputs[1].cell_names == [f"GRUCell_{i}" for i in range(4)]
    assert stacked.output_shape() == (4, 4)
    rng = np.random.default_rng(0)
    batch = {"a": rng.integers(0, 10, 3), "b": rng.integers(0, 20, 3),
             "h": rng.integers(0, 9, (3, 5)), "h_len": np.array([5, 2, 0]),
             "l": rng.integers(0, 9, (3, 5))}
    out = inputs({k: torch.as_tensor(v) for k, v in batch.items()})
    assert out["emb_inputs"].shape == (3, 4, 4) and out["seq_inputs"].shape == (3, 5, 4)
