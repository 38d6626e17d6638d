"""The port's multi-step dispatch (``Trainer(steps_per_execution=K)``,
``train.steps.make_train_scan``) against single steps and the JAX
package's stacked dispatch.  On the CPU the K steps of a dispatch run
eagerly in place of the CUDA graph, through the same packed group, static
buffer, per-step views and loss buffer; the graph itself is held to eager
steps on the card by ``chip_smoke.py``."""

import jax
import numpy as np
import pytest
import torch
from test_torch_train import JaxRun, _assert_params_close, _batches, _port, _schema

from torecsys_tpu import inputs as jax_inputs
from torecsys_tpu.train import Pipeline as JaxPipeline
from torecsys_tpu.train import Trainer as JaxTrainer
from torecsys_tpu_torch import Inputs, MultiIndicesEmbedding, Pipeline, Trainer, ValueInput
from torecsys_tpu_torch.data.packed import BatchLayout, group_batches


def _fm_batches(n, seed, b=16, vocab=10):
    rng = np.random.default_rng(seed)
    return [{"c": rng.integers(0, vocab, b).astype(np.int32),
             "d": rng.normal(size=b).astype(np.float32),
             "label": (rng.uniform(size=b) < 0.5).astype(np.float32)} for _ in range(n)]


def _fm_trainer(spe, sparse=True, presort=None):
    inputs = Inputs({"feat_inputs": ValueInput(("d",)),
                     "emb_inputs": MultiIndicesEmbedding(4, (10,), ("c",), device="cpu")})
    pipe = (Pipeline(device="cpu").set_objective("ctr").set_inputs(inputs)
            .set_model("DeepFM", deep_layer_sizes=(8,)).set_criterion("BCEWithLogitsLoss")
            .set_optimizer("Adam", lr=1e-2).set_sparse_embeddings(sparse)
            .set_target_fields("label"))
    return Trainer(pipe, log_every=1000, steps_per_execution=spe, presort=presort)


@pytest.mark.parametrize("sparse,presort", [(True, None), (True, False), (False, None)])
def test_steps_per_execution_remainder_reaches_every_step(sparse, presort):
    """tests/test_trainer.py:191: 7 batches a epoch in dispatches of 3 (two
    full, a remainder of one taken as a single step), 2 epochs: step 14,
    with every loss equal to single steps' to the bit."""
    batches = _fm_batches(7, seed=0)
    runs = {}
    for spe in (1, 3):
        trainer = _fm_trainer(spe, sparse, presort)
        trainer.init_state()
        losses = trainer.train_steps(batches) + trainer.train_steps(batches)
        runs[spe] = torch.stack(losses).tolist()
        assert int(trainer.state.step) == 14 and trainer.state.loss_count == 14
        if spe == 3:
            assert trainer._train_scan is not None and trainer._train_scan.k == 3
    assert runs[1] == runs[3]
    trainer = _fm_trainer(3, sparse, presort)
    metrics = trainer.fit(lambda: iter(batches), max_epochs=2)
    assert np.isfinite(metrics["train_loss"]) and int(trainer.state.step) == 14


def test_groups_close_on_a_new_shape_and_take_single_steps():
    """Batches whose shapes differ from the group's start a new group; a
    full group of another layout than the scan's takes single steps."""
    batches = _fm_batches(5, seed=1) + _fm_batches(3, seed=2, b=8)
    assert [len(g) for g in group_batches(batches, 3)] == [3, 2, 3]
    single, stacked = _fm_trainer(1), _fm_trainer(3)
    for t in (single, stacked):
        t.init_state()
    ref = torch.stack(single.train_steps(batches)).tolist()
    got = torch.stack(stacked.train_steps(batches)).tolist()
    assert got == ref and int(stacked.state.step) == 8
    assert stacked._train_scan.layout == BatchLayout.of(stacked._presorter(batches[0]))
    with pytest.raises(ValueError, match="does not fit"):
        stacked._train_scan(stacked.state, torch.zeros(2, 8, dtype=torch.uint8))


def test_stacked_dispatch_carries_the_presort_aux_as_the_jax_package_does():
    """tests/test_presort.py:338: presort aux through the stacked dispatch
    of 3 steps, against the JAX Trainer's stacked dispatch from the same
    weights, and against the port's single steps to the bit."""
    batches = _batches()[:4] + _batches()[:2]
    pipe = (JaxPipeline().set_objective("ctr")
            .set_inputs(_schema(jax_inputs))
            .set_model("DeepFM", deep_layer_sizes=(32, 16)).set_criterion("BCEWithLogitsLoss")
            .set_optimizer("Adam", lr=1e-3).set_sparse_embeddings(True)
            .set_target_fields("label"))
    ref = JaxTrainer(pipe, presort=True, prefetch=2, log_every=10_000, steps_per_execution=3,
                     seed=0)
    ref.init_state(batches[0])
    params0 = jax.device_get(ref.state.params)
    ref.fit(lambda: iter(batches), max_epochs=1)
    ports = []
    for spe in (1, 3):
        port = _port(params0)
        port.steps_per_execution = spe
        port.fit(lambda: iter(batches), max_epochs=1)
        assert port._presorter is not None and int(port.state.step) == 6
        ports.append(port)
    _assert_params_close(ports[1], jax.device_get(ref.state.params))
    for (name, a), b in zip(ports[0].pipeline.sequential.named_parameters(),
                            ports[1].pipeline.sequential.parameters()):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy(), err_msg=name)


def test_profile_dir_writes_a_trace_of_a_few_steps(tmp_path):
    trainer = _fm_trainer(3)
    trainer.profile_dir = str(tmp_path)
    trainer.fit(lambda: iter(_fm_batches(12, seed=3)), max_epochs=1)
    assert (tmp_path / "trainer_trace.json").stat().st_size > 0
    assert trainer.profile_dir is None  # traced once
    assert '"torecsys.step"' in (tmp_path / "trainer_trace.json").read_text()


def test_carried_over_weights_train_the_same_through_the_scan():
    """A dense-route dispatch of 5 steps from the JAX Trainer's weights
    tracks the JAX Trainer's single steps (test_torch_dense's bounds)."""
    batches = _batches()
    ref = JaxRun(batches, sparse=False)
    port = _port(ref.params(), sparse=False)
    port.steps_per_execution = len(batches)
    ref_losses = [ref.step(b) for b in batches]
    losses = [float(x) for x in port.train_steps(batches)]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    _assert_params_close(port, ref.params())
