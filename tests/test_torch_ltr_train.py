"""The ``ltr`` and ``emb`` objectives and the regularizer through the port's
``Trainer`` against the JAX package's ``Trainer``, from the same weights.

The JAX side mines with :class:`ReplayMiner` (``test_torch_ltr``): for the
key its step folds from its state's rng and the step (and its evaluation
from ``PRNGKey(0)`` and the batch's index), it takes the rows the port's
``UniformBatchMiner`` draws for the same step (or batch index) with the
port's keys, so both sides see the same negatives; nothing of the JAX
package changes.

* ``ltr`` with BPR on NCF, Hinge on MF, ListNet on MF with a regularizer on
  the table, AdaptiveHinge on NCF with the default (kernel) regularizer, and
  ``emb`` with StarSpace; a regularized ``ctr`` DeepFM on the presorted, the
  on-device and the dense route: five free steps' losses at rtol 1e-5, then
  a sixth step of each from the JAX Trainer's state, after which the whole
  state lies within atol 1e-6 (``test_torch_field_aware``'s rule).
* ``evaluate``'s ``val_ndcg@k`` against the JAX Trainer's from the same
  (trained) weights and the same draws, atol 1e-6.
  A ranking loss reads only differences of scores, so the bias added last
  to every score (NCF's ``model/deep/output/bias``) has gradient 0 in exact
  arithmetic: the JAX package's stays 0, the port's sums leave rounding
  noise of up to 2^-24 (a hardest-negative tie splits a gradient in thirds),
  which Adam scales to steps of about lr.  Its gradient is held at that
  noise, its value is not compared (the rule ``test_torch_field_aware``
  keeps for the CIN's biases).
* ``fit`` at ``steps_per_execution=8`` takes the eager steps' losses; the
  dense route is the only one for ``ltr``; the sparse step refuses a
  regularizer on a table with the JAX package's message."""

import dataclasses
import re
from typing import Optional

import jax
import numpy as np
import pytest
import torch

from torecsys_tpu import inputs as J
from torecsys_tpu.train import Pipeline as JaxPipeline
from torecsys_tpu.train import Trainer as JaxTrainer
from torecsys_tpu_torch import inputs as T
from torecsys_tpu_torch import Pipeline, Trainer
from torecsys_tpu_torch.convert import from_flax_params
from torecsys_tpu_torch.miners import UniformBatchMiner
from torecsys_tpu_torch.train.steps import eval_miner_key, miner_key
import test_torch_field_aware
from test_torch_field_aware import ROUTES, assert_state_close, batches
from test_torch_field_aware import schema as ctr_schema
from test_torch_ltr import ReplayMiner

USERS, ITEMS, E, B, STEPS, LR = 60, 40, 8, 64, 5, 1e-3


def interactions(n, seed=0):
    """User→item interactions with a planted preference (each user prefers
    a cluster of three items), as the JAX package's Trainer tests plant one."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, USERS, n).astype(np.int32)
    preferred = (u * 3) % ITEMS
    noise = rng.integers(0, ITEMS, n)
    item = np.where(rng.uniform(size=n) < 0.8, (preferred + rng.integers(0, 3, n)) % ITEMS, noise)
    return {"user": u, "item": item.astype(np.int32), "label": np.ones(n, np.float32)}


def feed(n_batches, seed=0):
    data = interactions(B * n_batches, seed)
    return [{k: v[i * B:(i + 1) * B] for k, v in data.items()} for i in range(n_batches)]


def schema(kind, mod):
    """The ranking cases' inputs in the JAX package (``mod is J``) or the port."""
    port = mod is T
    dev = {"device": "cpu"} if port else {}
    if kind == "pair":  # MF, NCF: the (B, 2, E) user and item rows of one fused table
        return {"emb_inputs": (T.MultiIndicesEmbedding(E, (USERS, ITEMS), ("user", "item"), **dev)
                               if port else J.MultiIndicesEmbedding(
                                   embed_size=E, field_sizes=(USERS, ITEMS),
                                   fields=("user", "item")))}
    # StarSpace: a packed context table and an unpacked target table
    return {"context_inputs": (T.MultiIndicesEmbedding(E, (USERS,), ("user",), **dev) if port
                               else J.MultiIndicesEmbedding(embed_size=E, field_sizes=(USERS,),
                                                            fields=("user",))),
            "target_inputs": (T.SingleIndexEmbedding(ITEMS, E, ("item",), **dev) if port
                              else J.SingleIndexEmbedding(field_size=ITEMS, embed_size=E,
                                                          fields=("item",)))}


@dataclasses.dataclass(frozen=True)
class Case:
    objective: str
    kind: str
    model: str
    model_kwargs: dict
    criterion: str
    criterion_kwargs: dict = dataclasses.field(default_factory=dict)
    num_negs: int = 4
    regularizer: Optional[dict] = None
    route: str = "dense"


CASES = {
    "ltr_bpr_ncf": Case("ltr", "pair", "NCF", {"deep_layer_sizes": (8,)},
                        "BayesianPersonalizedRankingLoss"),
    "ltr_hinge_mf": Case("ltr", "pair", "MF", {}, "HingeLoss", {"margin": 0.5}, num_negs=3),
    "ltr_listnet_mf_table_penalty": Case(
        "ltr", "pair", "MF", {}, "ListnetLoss",
        regularizer={"weight_decay": 1e-2, "key_filter": "schema_emb_inputs"}),
    "ltr_adaptive_hinge_ncf_kernel_penalty": Case(
        "ltr", "pair", "NCF", {"deep_layer_sizes": (8,)}, "AdaptiveHingeLoss",
        regularizer={"weight_decay": 1e-2}),
    # the JAX Trainer initializes StarSpace on a plain batch, which it reads
    # as blocks of 1 + num_neg rows: B = 64 takes num_neg = 3
    "emb_starspace_bpr": Case("emb", "starspace", "StarSpace", {"embed_size": E, "num_neg": 3},
                              "BayesianPersonalizedRankingLoss", num_negs=3),
    **{f"ctr_deepfm_kernel_penalty_{route}": Case(
        "ctr", "fused", "DeepFM", {"deep_layer_sizes": (8,)}, "BCEWithLogitsLoss",
        regularizer={"weight_decay": 1e-2, "norm": 2}, route=route)
       for route in ("presorted", "ondevice", "dense")},
}


def _inputs(case, mod):
    if case.objective == "ctr":
        return ctr_schema(case.kind, mod)
    return schema(case.kind, mod)


def _target(case):
    return "item" if case.objective != "ctr" else None


def jax_trainer(case, eval_batches=0, ndcg_k=10):
    """The JAX Trainer of ``case``; on ``ltr``/``emb`` its miner replays
    the port's draws for steps 0..STEPS and for ``eval_batches`` evaluation
    batches."""
    route = ROUTES[case.route]
    pipe = (JaxPipeline().set_objective(case.objective)
            .set_inputs(J.Inputs(schema=_inputs(case, J)))
            .set_model(case.model, **case.model_kwargs)
            .set_criterion(case.criterion, **case.criterion_kwargs)
            .set_optimizer("Adam", lr=LR).set_sparse_embeddings(route.sparse)
            .set_target_fields("label"))
    if case.regularizer is not None:
        pipe.set_regularizer(**case.regularizer)
    if case.objective != "ctr":
        # the JAX Trainer's state key: the second half of PRNGKey(seed)'s split
        _, rng = jax.random.split(jax.random.PRNGKey(0))
        port_miner = UniformBatchMiner(case.num_negs)
        keys, draws = [], []
        for s in range(STEPS + 1):
            keys.append(jax.random.fold_in(jax.random.fold_in(rng, s), 2))
            draws.append(port_miner.draw(miner_key(0, torch.tensor(s, dtype=torch.int32)), B))
        for i in range(eval_batches):
            keys.append(jax.random.fold_in(jax.random.PRNGKey(0), i))
            draws.append(port_miner.draw(eval_miner_key(i), B))
        pipe.set_miner(ReplayMiner(case.num_negs, keys, [d.numpy() for d in draws]))
        pipe.set_miner_target_field(_target(case))
    return JaxTrainer(pipe, presort=route.presort, prefetch=0, seed=0, ndcg_k=ndcg_k)


class JaxRun:
    def __init__(self, case, data, **kwargs):
        self.t = jax_trainer(case, **kwargs)
        self.t.init_state(data[0])
        self.t._setup_presorter()
        self.t._build_steps()
        if case.objective != "ctr":
            _, rng = jax.random.split(jax.random.PRNGKey(0))
            assert np.array_equal(np.asarray(self.t.state.rng), np.asarray(rng))
        self.params0 = jax.device_get(self.t.state.params)

    def step(self, batch):
        if self.t._presorter is not None:
            batch = self.t._presorter(batch)
        with self.t._trace_contexts():
            self.t.state, logs = self.t._train_step_fn(self.t.state, self.t._place_batch(batch))
        return float(logs["loss"])

    def params(self):
        return jax.device_get(self.t.state.params)

    def stats(self):
        return jax.device_get(self.t.state.batch_stats)


def port_trainer(case, params, opt_state=None, spe=1, ndcg_k=10):
    route = ROUTES[case.route]
    pipe = (Pipeline(device="cpu").set_objective(case.objective)
            .set_inputs(T.Inputs(_inputs(case, T)))
            .set_model(case.model, **case.model_kwargs)
            .set_criterion(case.criterion, **case.criterion_kwargs)
            .set_optimizer("Adam", lr=LR).set_sparse_embeddings(route.sparse)
            .set_target_fields("label"))
    if case.regularizer is not None:
        pipe.set_regularizer(**case.regularizer)
    if case.objective != "ctr":
        pipe.set_miner("UniformBatchMiner", num_negs=case.num_negs)
        pipe.set_miner_target_field(_target(case))
    trainer = Trainer(pipe, presort=route.presort, prefetch=0, steps_per_execution=spe,
                      ndcg_k=ndcg_k)
    trainer.init_state()
    from_flax_params(pipe.sequential, params, opt_state, trainer.state if opt_state else None)
    return trainer


def _data(case, n):
    return batches(n) if case.objective == "ctr" else feed(n)


# the bias added last to every score: gradient 0 under a ranking loss
SHIFT_BIAS = "model.deep.output.bias"


@pytest.mark.parametrize("name", sorted(CASES))
def test_trainer_tracks_the_jax_trainer(name, monkeypatch):
    case = CASES[name]
    monkeypatch.setenv("TORECSYS_TPU_FUSED_DEDUP", ROUTES[case.route].fused)
    data = _data(case, STEPS + 1)
    ref = JaxRun(case, data)
    port = port_trainer(case, ref.params0)
    shift_grads = []
    shift = dict(port.pipeline.sequential.named_parameters()).get(SHIFT_BIAS)
    ranking = case.objective != "ctr" and shift is not None
    if ranking:
        shift.register_hook(lambda g: shift_grads.append(float(g.abs().max())))
        monkeypatch.setattr(test_torch_field_aware, "DEAD_PARAMS",
                            re.compile(r"^model/deep/output/bias$"))
    want = [ref.step(b) for b in data[:STEPS]]
    got = [float(x) for x in port.train_steps(data[:STEPS])]
    if ranking:  # the summed gradient of both applications, once a step
        assert len(shift_grads) == STEPS and max(shift_grads) <= 2.0**-24
    assert port.sparse == ROUTES[case.route].sparse
    assert (port._presorter is not None) == (case.route == "presorted")
    np.testing.assert_allclose(got, want, rtol=1e-5)
    port = port_trainer(case, ref.params(), jax.device_get(ref.t.state.opt_state))
    assert int(port.state.step) == STEPS
    np.testing.assert_allclose(float(port.train_steps(data[STEPS:])[0]), ref.step(data[STEPS]),
                               rtol=1e-5)
    assert int(port.state.step) == STEPS + 1
    assert_state_close(port, ref.params(), ref.stats())


@pytest.mark.parametrize("name", ["ltr_bpr_ncf", "ltr_hinge_mf"])
@pytest.mark.parametrize("ndcg_k", [3, 10])
def test_ranking_evaluation_matches_the_jax_trainer(name, ndcg_k):
    """``val_ndcg@k`` over 4 held-out batches from the JAX Trainer's weights
    after 5 steps, the same lists mined on both sides."""
    case = CASES[name]
    data, held = feed(STEPS), feed(4, seed=1)
    ref = JaxRun(case, data, eval_batches=len(held), ndcg_k=ndcg_k)
    for b in data:
        ref.step(b)
    port = port_trainer(case, ref.params(), ndcg_k=ndcg_k)
    want = ref.t.evaluate(held)
    got = port.evaluate(held)
    assert set(got) == set(want) == {f"val_ndcg@{ndcg_k}"}
    np.testing.assert_allclose(got[f"val_ndcg@{ndcg_k}"], want[f"val_ndcg@{ndcg_k}"], atol=1e-6)
    assert port.evaluate(held) == got  # the same lists every time


@pytest.mark.parametrize("objective", ["ltr", "emb"])
def test_fit_at_eight_steps_a_dispatch_takes_the_eager_steps(objective):
    case = CASES["ltr_bpr_ncf" if objective == "ltr" else "emb_starspace_bpr"]
    data, held = feed(16), feed(2, seed=1)
    params = JaxRun(case, data).params0
    eager, graphed = port_trainer(case, params), port_trainer(case, params, spe=8)
    want = [float(x) for x in eager.train_steps(data)]
    metrics = graphed.fit(data, val_loader=held, max_epochs=1)
    assert graphed.sparse is False and graphed._presorter is None
    np.testing.assert_allclose(metrics["train_loss"], np.mean(want), rtol=1e-6)
    assert int(graphed.state.step) == 16 and "val_ndcg@10" in metrics
    assert graphed.evaluate(held) == eager.evaluate(held)
    assert graphed.predict(held[0]).shape == (B, 1)


def test_sparse_route_refuses_the_ranking_objectives_and_a_table_penalty():
    case = CASES["ltr_hinge_mf"]
    params = JaxRun(case, feed(1)).params0
    pipe = port_trainer(case, params).pipeline
    with pytest.raises(ValueError, match="requires objective='ctr'"):
        Trainer(pipe.set_sparse_embeddings(True)).init_state()
    table_case = dataclasses.replace(CASES["ctr_deepfm_kernel_penalty_ondevice"],
                                     regularizer={"key_filter": "embedding"})
    data = batches(1)
    ref = JaxRun(table_case, data)
    with pytest.raises(ValueError) as want:
        ref.step(data[0])
    port = port_trainer(table_case, ref.params0)
    with pytest.raises(ValueError) as got:
        port.train_steps(data)
    assert str(got.value) == str(want.value)
    assert "inputs/schema_emb_inputs/embedding" in str(got.value)
