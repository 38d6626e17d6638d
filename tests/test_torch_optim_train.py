"""The port's Trainer under the optimizers beyond Adam, against the JAX
package's Trainer from the same weights and state.

* The sparse route with the row rules of AdamW, Adagrad and plain SGD
  (``RowAdam`` with optax's weight decay 1e-4, ``RowAdagrad``, ``RowSGD``)
  beside the dense optimizer of the same name, presorted and (Adagrad) on
  the device on both ``TORECSYS_TPU_FUSED_DEDUP`` settings; the dense route
  with Lamb, Lion and RMSprop over every parameter, the packed table with
  its padding rows included (Lamb's trust ratio takes its norm).  Five free
  steps with the losses held at rtol 1e-5, then a sixth from the JAX
  Trainer's state (parameters, optimizer state, row slots and step carried
  through ``convert.from_flax_params``), after which every parameter lies
  within atol 1e-6 and every optimizer state tensor and row slot within
  rtol 1e-5 / atol 1e-6 of the JAX Trainer's.
* The dense fallback, as ``torecsys_tpu/train/pipeline.py`` decides it: an
  optimizer without a row-wise twin (Lamb, ``SGD(momentum=0.9)``) or an
  opaque factory takes the dense route under ``set_sparse_embeddings(None)``
  and raises the JAX package's ``ValueError`` under ``True``.
* A checkpoint saved, restored and resumed to the bit under Adagrad (sparse)
  and Lion (dense), and the CLI training and evaluating under AdamW.
* The losses' reductions through ``get_reduction``, against the JAX losses.

``schema``, ``OptRef``, ``port_trainer`` and ``run_both`` also serve
``test_torch_fibinet``."""

import dataclasses
import functools
import os

import jax
import numpy as np
import optax
import pytest
import torch

from test_torch_field_aware import (
    CATS,
    DENSE,
    FIELDS,
    ROUTES,
    STEPS,
    assert_state_close,
    batches,
)
from torecsys_tpu import inputs as J
from torecsys_tpu import losses as JLoss
from torecsys_tpu.train import Pipeline as JaxPipeline
from torecsys_tpu.train import Trainer as JaxTrainer
from torecsys_tpu.utils import get_reduction as jax_get_reduction
from torecsys_tpu_torch import inputs as T
from torecsys_tpu_torch import losses as TLoss
from torecsys_tpu_torch import Pipeline, Trainer
from torecsys_tpu_torch.cli import run
from torecsys_tpu_torch.convert import flatten, from_flax_params, optax_fields, torch_name
from torecsys_tpu_torch.ops.sparse import RowAdagrad, RowAdam, RowSGD
from torecsys_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from torecsys_tpu_torch.train.steps import _held_tensors
from torecsys_tpu_torch.utils import get_reduction

LR = 1e-2


def schema(kind, mod, embed=8):
    """The inputs of each model kind in the JAX package (``mod is J``) or
    in the port: ``fused`` (dense values and a fused table), ``emb`` (the
    table alone: FiBiNET, DCN), ``field`` (a field-aware table alone:
    DeepFFM, FAT-DeepFFM)."""
    port = mod is T
    dev = {"device": "cpu"} if port else {}
    if kind == "field":
        return {"field_emb_inputs": (
            T.MultiIndicesFieldAwareEmbedding(embed, FIELDS, CATS, **dev) if port else
            J.MultiIndicesFieldAwareEmbedding(embed_size=embed, field_sizes=FIELDS, fields=CATS))}
    emb = (T.MultiIndicesEmbedding(embed, FIELDS, CATS, **dev) if port else
           J.MultiIndicesEmbedding(embed_size=embed, field_sizes=FIELDS, fields=CATS))
    if kind == "emb":
        return {"emb_inputs": emb}
    feat = T.ValueInput(DENSE) if port else J.ValueInput(fields=DENSE)
    return {"feat_inputs": feat, "emb_inputs": emb}


@dataclasses.dataclass(frozen=True)
class Config:
    """A model on its inputs, trained by a named optimizer."""

    kind: str
    model: str
    model_kwargs: tuple
    optimizer: str
    optimizer_kwargs: tuple = ()
    embed: int = 8

    def opt(self):
        return {"lr": LR, **dict(self.optimizer_kwargs)}


class OptRef:
    """The JAX Trainer's step under ``config``'s optimizer, one batch at a
    time, from its initial state."""

    def __init__(self, config, route, feed, sparse=None):
        sparse = route.sparse if sparse is None else sparse
        pipe = (JaxPipeline().set_objective("ctr")
                .set_inputs(J.Inputs(schema=schema(config.kind, J, config.embed)))
                .set_model(config.model, **dict(config.model_kwargs))
                .set_criterion("BCEWithLogitsLoss")
                .set_optimizer(config.optimizer, **config.opt())
                .set_sparse_embeddings(sparse).set_target_fields("label"))
        self.t = JaxTrainer(pipe, presort=route.presort, prefetch=0, seed=0)
        self.t.init_state(feed[0])
        self.t._setup_presorter()
        self.t._build_steps()
        self.params0 = jax.device_get(self.t.state.params)

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


def port_trainer(config, route, params, sparse=None, **trainer_kwargs):
    sparse = route.sparse if sparse is None else sparse
    pipe = (Pipeline(device="cpu").set_objective("ctr")
            .set_inputs(T.Inputs(schema(config.kind, T, config.embed)))
            .set_model(config.model, **dict(config.model_kwargs))
            .set_criterion("BCEWithLogitsLoss").set_optimizer(config.optimizer, **config.opt())
            .set_sparse_embeddings(sparse).set_target_fields("label"))
    trainer = Trainer(pipe, presort=route.presort, prefetch=0, **trainer_kwargs)
    trainer.init_state()
    from_flax_params(pipe.sequential, params)
    return trainer


def assert_opt_state_close(port, ref):
    """Every tensor of the dense optimizer's state and every row slot within
    rtol 1e-5 / atol 1e-6 of the JAX Trainer's."""
    opt_np = ref.opt_state()
    hybrid = isinstance(opt_np, dict) and "sparse" in opt_np
    fields = optax_fields(opt_np["dense"] if hybrid else opt_np)
    fields.pop("count", None)
    opt = port.state.opt_state["dense"] if hybrid else port.state.opt_state
    rename = {"mu": "exp_avg", "nu": "exp_avg_sq"} if isinstance(opt, torch.optim.Adam) else {}
    named = dict(port.pipeline.sequential.named_parameters())
    for field, tree in fields.items():
        for path, want in flatten(tree).items():
            want = np.asarray(want)
            got = opt.state[named[torch_name(path)]][rename.get(field, field)]
            np.testing.assert_allclose(got.numpy(), want.T if path.endswith("kernel") else want,
                                       rtol=1e-5, atol=1e-6, err_msg=f"{field} {path}")
    for path, slots in (opt_np["sparse"].items() if hybrid else ()):
        live = port.state.opt_state["sparse"][torch_name(path)]
        assert set(live) == set(slots)
        for k, want in slots.items():
            np.testing.assert_allclose(live[k].numpy(), np.asarray(want).reshape(live[k].shape),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{k} {path}")


def run_both(config, route_name, monkeypatch, feed=None, row_rule=None):
    """Five steps of each Trainer on one route from the same weights, the
    losses held; then one step of each from the JAX Trainer's state, and
    the parameters, the optimizer state and the row slots held after it."""
    route = ROUTES[route_name]
    feed = feed or batches(STEPS + 1)
    monkeypatch.setenv("TORECSYS_TPU_FUSED_DEDUP", route.fused)
    ref = OptRef(config, route, feed)
    port = port_trainer(config, route, ref.params0)
    assert port.sparse == route.sparse
    if row_rule is not None:
        assert isinstance(port.pipeline.row_optimizer(), row_rule)
    want = [ref.step(b) for b in feed[:STEPS]]
    got = [float(x) for x in port.train_steps(feed[:STEPS])]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    port = port_trainer(config, route, ref.params())
    from_flax_params(port.pipeline.sequential, ref.params(), ref.opt_state(), port.state,
                     step=int(ref.t.state.step))
    np.testing.assert_allclose(float(port.train_steps(feed[STEPS:])[0]), ref.step(feed[STEPS]),
                               rtol=1e-5)
    assert int(port.state.step) == STEPS + 1
    assert_state_close(port, ref.params(), None)
    assert_opt_state_close(port, ref)
    return port, ref


DEEPFM = ("fused", "DeepFM", (("deep_layer_sizes", (16,)),))

SPARSE_CASES = {
    "adamw_presorted": (Config(*DEEPFM, "AdamW"), "presorted", RowAdam),
    "adamw_decay_presorted": (Config(*DEEPFM, "AdamW", (("weight_decay", 0.05),)),
                              "presorted", RowAdam),
    "adagrad_presorted": (Config(*DEEPFM, "Adagrad"), "presorted", RowAdagrad),
    "adagrad_ondevice": (Config(*DEEPFM, "Adagrad"), "ondevice", RowAdagrad),
    "adagrad_ondevice_fused": (Config(*DEEPFM, "Adagrad"), "ondevice_fused", RowAdagrad),
    "sgd_presorted": (Config(*DEEPFM, "SGD"), "presorted", RowSGD),
}
DENSE_CASES = {
    "lamb": Config(*DEEPFM, "Lamb", (("weight_decay", 0.01),)),
    "lion": Config(*DEEPFM, "Lion"),
    "rmsprop": Config(*DEEPFM, "RMSprop", (("centered", True), ("momentum", 0.9))),
}


@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
def test_sparse_route_row_rules_match_the_jax_trainer(case, monkeypatch):
    config, route, rule = SPARSE_CASES[case]
    port, _ = run_both(config, route, monkeypatch, row_rule=rule)
    dense = port.state.opt_state["dense"]
    assert type(dense).__name__ == {"AdamW": "MultiTensorAdamW", "Adagrad": "Adagrad",
                                    "SGD": "SGD"}[config.optimizer]


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_route_optimizers_match_the_jax_trainer(case, monkeypatch):
    port, _ = run_both(DENSE_CASES[case], "dense", monkeypatch)
    table = port.pipeline.inputs.schema["emb_inputs"].embedding
    assert table.shape[0] * 16 > sum(FIELDS)  # the packed table has padding rows
    assert table in port.state.opt_state.state


FALLBACK = {
    "lamb": ("Lamb", {}),
    "sgd_momentum": ("SGD", {"momentum": 0.9}),
    "opaque": (functools.partial(torch.optim.SGD, lr=LR), {}),
}


@pytest.mark.parametrize("case", sorted(FALLBACK))
def test_an_optimizer_without_a_row_twin_falls_back_to_the_dense_route(case, monkeypatch):
    """``set_sparse_embeddings(None)``: the dense route, at any table size;
    ``True``: the JAX package's ``ValueError``."""
    opt, kwargs = FALLBACK[case]
    pipe = (Pipeline(device="cpu").set_inputs(T.Inputs(schema("fused", T)))
            .set_model("DeepFM", deep_layer_sizes=(8,)).set_optimizer(opt, **kwargs))
    assert pipe.row_optimizer() is None
    assert (pipe.optimizer_spec is None) == (case == "opaque")
    monkeypatch.setattr("torecsys_tpu_torch.train.trainer.SPARSE_AUTO_MIN_ELEMENTS", 0)
    trainer = Trainer(pipe, presort=False)  # any table would take the sparse route
    trainer.init_state()
    assert trainer.sparse is False and not isinstance(trainer.state.opt_state, dict)
    assert np.isfinite(float(trainer.train_steps(batches(2))[-1]))
    pipe.set_sparse_embeddings(True)
    match = "not an opaque transform" if case == "opaque" else (
        "no row-wise .lazy. formulation; supported: Adam, AdamW, Adagrad, SGD.plain.")
    with pytest.raises(ValueError, match=match):
        pipe.row_optimizer()
    jax_opt = (optax.sgd(LR),) if case == "opaque" else (opt,)
    jax_pipe = JaxPipeline().set_optimizer(*jax_opt, **kwargs).set_sparse_embeddings(True)
    with pytest.raises(ValueError, match=match):
        jax_pipe.row_optimizer()


def test_lamb_falls_back_dense_and_matches_the_jax_trainer(monkeypatch):
    """Lamb under ``set_sparse_embeddings(None)`` on both sides: the JAX
    Trainer and the port's take the dense route, and agree."""
    config = Config(*DEEPFM, "Lamb")
    route = ROUTES["dense"]
    feed = batches(STEPS)
    ref = OptRef(config, route, feed, sparse=None)
    port = port_trainer(config, route, ref.params0, sparse=None)
    assert port.sparse is False and not ref.t._sparse
    want = [ref.step(b) for b in feed]
    np.testing.assert_allclose([float(x) for x in port.train_steps(feed)], want, rtol=1e-5)


def test_the_opaque_form_trains_the_dense_route():
    """``set_optimizer(<factory>)``: any ``params -> torch.optim.Optimizer``
    over every parameter, the tables included; keywords are refused."""
    built = []

    def factory(params):
        built.append(list(params))
        return torch.optim.SGD(built[-1], lr=LR, momentum=0.5)

    pipe = (Pipeline(device="cpu").set_inputs(T.Inputs(schema("fused", T)))
            .set_model("DeepFM", deep_layer_sizes=(8,)).set_optimizer(factory))
    trainer = Trainer(pipe)
    trainer.init_state()
    assert trainer.sparse is False and isinstance(trainer.state.opt_state, torch.optim.SGD)
    assert len(built[0]) == len(list(pipe.sequential.parameters()))
    table = pipe.inputs.schema["emb_inputs"].embedding
    before = table.detach().clone()
    assert np.isfinite(float(trainer.train_steps(batches(2))[-1]))
    assert not torch.equal(before, table.detach())
    with pytest.raises(TypeError, match="no keywords"):
        pipe.set_optimizer(factory, lr=0.1)
    with pytest.raises(TypeError, match="registry name"):
        pipe.set_optimizer(3)


def _bits(t):
    return t.detach().view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                            8: torch.int64}[t.element_size()])


@pytest.mark.parametrize("optimizer,sparse", [("Adagrad", True), ("Lion", False)])
def test_checkpoint_round_trip_and_resume_are_bit_exact(optimizer, sparse, tmp_path):
    feed = batches(7, seed=3)

    def fresh(**kw):
        pipe = (Pipeline(device="cpu").set_inputs(T.Inputs(schema("fused", T)))
                .set_model("DeepFM", deep_layer_sizes=(16,))
                .set_optimizer(optimizer, lr=LR).set_sparse_embeddings(sparse))
        t = Trainer(pipe, seed=5, **kw)
        t.init_state()
        return t

    straight = fresh()
    want = [float(x) for x in straight.train_steps(feed)]
    first = fresh(checkpoint_dir=str(tmp_path))
    got = [float(x) for x in first.train_steps(feed[:4])]
    saved = [t.detach().clone() for t in _held_tensors(first.pipeline.sequential, first.state)]
    path = first.save_checkpoint()
    first.train_steps(feed[4:5])
    live = _held_tensors(first.pipeline.sequential, first.state)
    ptrs = [t.data_ptr() for t in live]
    restore_checkpoint(path, first.pipeline.sequential, first.state)
    after = _held_tensors(first.pipeline.sequential, first.state)
    assert [t.data_ptr() for t in after] == ptrs
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(saved, after))
    resumed = fresh(checkpoint_dir=str(tmp_path))
    assert int(resumed.state.step) == 4 and resumed.sparse is sparse
    got += [float(x) for x in resumed.train_steps(feed[4:])]
    assert got == want
    for a, b in zip(_held_tensors(resumed.pipeline.sequential, resumed.state),
                    _held_tensors(straight.pipeline.sequential, straight.state)):
        assert torch.equal(_bits(a), _bits(b))


def test_checkpoint_of_another_optimizer_is_refused(tmp_path):
    def fresh(optimizer):
        pipe = (Pipeline(device="cpu").set_inputs(T.Inputs(schema("fused", T)))
                .set_model("DeepFM", deep_layer_sizes=(8,)).set_optimizer(optimizer)
                .set_sparse_embeddings(False))
        t = Trainer(pipe)
        t.init_state()
        return t

    lion = fresh("Lion")
    path = save_checkpoint(str(tmp_path / "ckpt_0.pt"), lion.pipeline.sequential, lion.state)
    rms = fresh("RMSprop")
    with pytest.raises(ValueError, match="does not match"):
        restore_checkpoint(path, rms.pipeline.sequential, rms.state)


def test_checkpoint_saved_before_a_first_step_is_refused_by_a_built_state(tmp_path):
    """torch.optim.Adam saves no state for a parameter before its first
    step; the written-out optimizers build theirs with themselves, so such
    a checkpoint restored into one is another optimizer's: refused, the live
    state left whole.  Into torch's Adam it restores, emptying the state."""
    def fresh(optimizer):
        pipe = (Pipeline(device="cpu").set_inputs(T.Inputs(schema("fused", T)))
                .set_model("DeepFM", deep_layer_sizes=(8,)).set_optimizer(optimizer)
                .set_sparse_embeddings(False))
        t = Trainer(pipe)
        t.init_state()
        return t

    adam = fresh("Adam")
    path = save_checkpoint(str(tmp_path / "ckpt_0.pt"), adam.pipeline.sequential, adam.state)
    adagrad = fresh("Adagrad")
    with pytest.raises(ValueError, match="does not match"):
        restore_checkpoint(path, adagrad.pipeline.sequential, adagrad.state)
    assert all(set(s) == {"sum_of_squares"} for s in adagrad.state.opt_state.state.values())
    adam.train_steps(batches(1))
    assert adam.state.opt_state.state
    restore_checkpoint(path, adam.pipeline.sequential, adam.state)
    assert not adam.state.opt_state.state


SAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "torecsys_tpu", "data", "sample", "criteo_sample.tsv")


def test_cli_trains_and_evaluates_under_adamw(tmp_path):
    common = ["--device", "cpu", "--criteo_hash_size", "500", "--embed_size", "4",
              "--optimizer_config", '{"method": "AdamW", "lr": 0.01, "weight_decay": 0.001}']
    trainer = run(["train", "--model_config", '{"method": "FM"}', "--train_file", SAMPLE,
                   "--batch_size", "256", "--max_num_epochs", "1", "--checkpoint_dir",
                   str(tmp_path), *common])
    dense = trainer.state.opt_state["dense"] if trainer.sparse else trainer.state.opt_state
    assert type(dense).__name__ == "MultiTensorAdamW" and dense.defaults["weight_decay"] == 0.001
    ckpt = sorted(os.listdir(tmp_path))[-1]
    metrics = run(["evaluate", "--model_config", '{"method": "FM"}', "--load_from",
                   str(tmp_path / ckpt), "--eval_file", SAMPLE, *common])
    assert 0.0 <= metrics["val_auc"] <= 1.0


# ---- reductions ------------------------------------------------------------------

REDUCTIONS = ["mean", "avg", "sum", "none", None, "callable"]


@pytest.mark.parametrize("reduction", REDUCTIONS, ids=str)
@pytest.mark.parametrize("loss", ["BCEWithLogitsLoss", "BCELoss", "MSELoss"])
def test_losses_take_every_reduction_of_get_reduction(loss, reduction):
    """Fault 1 of ``ROADMAP.md`` section 3, closed: the JAX losses resolve
    ``reduction`` through ``get_reduction``, and so do the port's."""
    jred = (lambda x: x.max()) if reduction == "callable" else reduction
    tred = (lambda x: x.max()) if reduction == "callable" else reduction
    preds = np.array([[0.3], [-1.2], [0.7]], np.float32)
    if loss == "BCELoss":
        preds = 1 / (1 + np.exp(-preds))
    labels = np.array([1.0, 0.0, 1.0], np.float32)
    want = np.asarray(getattr(JLoss, loss)(reduction=jred)(preds, labels))
    got = getattr(TLoss, loss)(reduction=tred)(torch.from_numpy(preds), torch.from_numpy(labels))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_get_reduction_matches_the_jax_function():
    x = np.array([[0.5, -1.0], [2.0, 0.25]], np.float32)
    for method in ("mean", "avg", "sum", "none", None):
        np.testing.assert_allclose(get_reduction(method)(torch.from_numpy(x)).numpy(),
                                   np.asarray(jax_get_reduction(method)(x)), rtol=1e-7)
    assert get_reduction(torch.amax) is torch.amax
    with pytest.raises(ValueError, match="unknown reduction"):
        get_reduction("max")
    with pytest.raises(ValueError, match="unknown reduction"):
        jax_get_reduction("max")
    logits, labels = torch.tensor([0.3, -1.2]), torch.tensor([1.0, 0.0])
    assert float(TLoss.BCEWithLogitsLoss(reduction="avg")(logits, labels)) == pytest.approx(
        0.40881884, rel=1e-6)
    np.testing.assert_allclose(TLoss.BCEWithLogitsLoss(reduction=None)(logits, labels).numpy(),
                               [0.5543552, 0.2632825], rtol=1e-6)


@pytest.mark.parametrize("optimizer", ["Lion", "Adagrad", "Lamb"])
def test_a_bf16_table_keeps_its_optimizer_state_in_bf16(optimizer):
    """``set_table_dtype("bfloat16")`` on the dense route: the table's state
    is bf16, as optax keeps a bf16 leaf's; the tower's stays float32."""
    pipe = (Pipeline(device="cpu").set_inputs(T.Inputs(schema("fused", T)))
            .set_model("DeepFM", deep_layer_sizes=(8,)).set_optimizer(optimizer, lr=LR)
            .set_table_dtype("bfloat16"))
    trainer = Trainer(pipe)
    trainer.init_state()
    table = pipe.inputs.schema["emb_inputs"].embedding
    before = table.detach().clone()
    assert trainer.sparse is False and table.dtype == torch.bfloat16
    assert np.isfinite(float(trainer.train_steps(batches(2))[-1]))
    opt = trainer.state.opt_state
    assert all(v.dtype == torch.bfloat16 for k, v in opt.state[table].items() if k != "step")
    tower = pipe.model.deep.output.weight
    assert all(v.dtype == torch.float32 for v in opt.state[tower].values())
    assert not torch.equal(before, table.detach())
