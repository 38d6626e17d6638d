"""The slice end to end: sparse train steps of the port's Trainer against
the JAX package's Trainer (sparse embeddings, host presort on), from the
same carried-over initial weights, on ``make_synthetic_ctr`` batches.

``JaxRun``, ``_port`` and ``_assert_params_close`` also serve the dense
route's and the evaluation's tests (``test_torch_dense``,
``test_torch_eval``)."""

import jax
import numpy as np
import pytest
import torch

from torecsys_tpu import inputs as jax_inputs
from torecsys_tpu.data.sample_data import make_synthetic_ctr
from torecsys_tpu.train import Pipeline as JaxPipeline
from torecsys_tpu.train import Trainer as JaxTrainer
from torecsys_tpu_torch import Inputs, MultiIndicesEmbedding, Pipeline, Trainer, ValueInput
from torecsys_tpu_torch.convert import flatten, from_flax_params, torch_name
from torecsys_tpu_torch.ops.embedding import unpack_table

FIELDS = (1000, 500, 200, 100, 50, 20)
NUM_DENSE, E, B, STEPS, LR = 4, 16, 256, 5, 1e-3
TOWER = (32, 16)
TABLE = "inputs/schema_emb_inputs/embedding"


def _batches():
    data = make_synthetic_ctr(num_rows=B * STEPS, field_sizes=FIELDS, num_dense=NUM_DENSE,
                              seed=0)
    return [{k: v[i * B:(i + 1) * B] for k, v in data.items()} for i in range(STEPS)]


def _schema(mod, embed=E):
    cat = tuple(f"cat_{i}" for i in range(len(FIELDS)))
    dense = tuple(f"dense_{j}" for j in range(NUM_DENSE))
    if mod is jax_inputs:
        return jax_inputs.Inputs(schema={
            "feat_inputs": jax_inputs.ValueInput(fields=dense),
            "emb_inputs": jax_inputs.MultiIndicesEmbedding(embed_size=embed, field_sizes=FIELDS,
                                                           fields=cat)})
    return Inputs({"feat_inputs": ValueInput(dense),
                   "emb_inputs": MultiIndicesEmbedding(embed, FIELDS, cat, device="cpu")})


class JaxRun:
    """The JAX Trainer's step, one batch at a time: the sparse step on
    presorted batches, or the dense step (``sparse=False``)."""

    def __init__(self, batches, sparse=True, embed=E):
        pipe = (JaxPipeline().set_objective("ctr").set_inputs(_schema(jax_inputs, embed))
                .set_model("DeepFM", deep_layer_sizes=TOWER)
                .set_criterion("BCEWithLogitsLoss").set_optimizer("Adam", lr=LR)
                .set_sparse_embeddings(sparse).set_target_fields("label"))
        self.t = JaxTrainer(pipe, presort=True, prefetch=0, seed=0)
        self.t.init_state(batches[0])
        self.t._setup_presorter()
        assert (self.t._presorter is not None) == sparse
        self.t._build_steps()

    def params(self):
        return jax.device_get(self.t.state.params)

    def opt_state(self):
        return jax.device_get(self.t.state.opt_state)

    def step(self, batch):
        if self.t._presorter is not None:
            batch = self.t._presorter(batch)
        placed = self.t._place_batch(batch)
        with self.t._trace_contexts():
            self.t.state, logs = self.t._train_step_fn(self.t.state, placed)
        return float(logs["loss"])


def _port(params_np, opt_state_np=None, sparse=True, embed=E):
    pipe = (Pipeline(device="cpu").set_objective("ctr").set_inputs(_schema(None, embed))
            .set_model("DeepFM", deep_layer_sizes=TOWER)
            .set_criterion("BCEWithLogitsLoss").set_optimizer("Adam", lr=LR)
            .set_sparse_embeddings(sparse).set_target_fields("label"))
    trainer = Trainer(pipe)
    trainer.init_state()
    from_flax_params(pipe.sequential, params_np, opt_state_np, trainer.state)
    return trainer


def _assert_params_close(trainer, params_np, embed=E, skip=()):
    named = dict(trainer.pipeline.sequential.named_parameters())
    for path, ref in flatten(params_np).items():
        if path in skip:
            continue
        got = named[torch_name(path)].detach().numpy()
        if path == TABLE:
            got = unpack_table(torch.tensor(got), embed, sum(FIELDS)).numpy()
            ref = unpack_table(torch.tensor(np.asarray(ref)), embed, sum(FIELDS)).numpy()
        elif path.endswith("kernel"):
            ref = np.asarray(ref).T
        # Tables: Adam moves a touched element by about lr per step; the
        # two sides' gradients differ in rounding only.  Dense params:
        # optax's float32 bias correction vs torch's float64 one (see
        # test_torch_model).  1e-6 is 1e-3 of lr.
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-6, err_msg=path)


def test_five_sparse_steps_track_the_jax_trainer():
    batches = _batches()
    ref = JaxRun(batches)
    port = _port(ref.params())
    ref_losses = [ref.step(b) for b in batches]
    losses = [float(x) for x in port.train_steps(batches)]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert int(port.state.step) == STEPS
    _assert_params_close(port, ref.params())
    # The row-wise moments carry the same state as the JAX package's.  The
    # dense params of the two sides differ by the Adam bias-correction
    # rounding (see _assert_params_close), which moves the table gradients
    # by about 1e-5 of their size, and sums that nearly cancel amplify that;
    # so the bound is set against each moment's scale: 1e-4 of its largest
    # element.
    got_mv = port.state.opt_state["sparse"][torch_name(TABLE)]["mv"].numpy()
    ref_mv = np.asarray(ref.opt_state()["sparse"][TABLE]["mv"])
    for k in range(2):
        np.testing.assert_allclose(got_mv[:, k], ref_mv[:, k], rtol=0,
                                   atol=1e-4 * np.abs(ref_mv[:, k]).max())


def test_optimizer_state_carry_over_continues_the_jax_run():
    batches = _batches()
    ref = JaxRun(batches)
    for b in batches[:2]:
        ref.step(b)
    port = _port(ref.params(), ref.opt_state())
    assert int(port.state.step) == 2
    loss = float(port.train_steps([batches[2]])[0])
    np.testing.assert_allclose(loss, ref.step(batches[2]), rtol=1e-5)
    _assert_params_close(port, ref.params())


def test_trainer_fit_reports_and_refuses_the_unported_dense_route():
    """fit reports; the automatic dense/sparse choice (None) is refused,
    naming the two explicit routes."""
    batches = _batches()
    port = _port(JaxRun(batches[:1]).params())
    metrics = port.fit(batches, max_steps=3)
    assert metrics["epoch"] == 0 and np.isfinite(metrics["train_loss"])
    assert int(port.state.step) == 3
    pipe = port.pipeline
    pipe.set_sparse_embeddings(None)
    with pytest.raises(NotImplementedError, match=r"set_sparse_embeddings\(False\)"):
        Trainer(pipe)
