"""The ranking and embedding objectives' parts against the JAX package's, on
inputs drawn from a numpy seed.

* Every loss class, forward and gradient, rtol 1e-6 against
  ``torecsys_tpu.losses``, with ties: an in-batch miner pairs an anchor with
  its own target now and then (``pos == neg``) and draws a negative twice,
  so the gradients' rules at ties (softplus at 0, ``maximum``, ``max``) are
  held too.
* ``metrics.functional`` and ``StreamingNDCG`` / ``Novelty`` on lists with
  tied scores and tied relevance, and ``-1`` pads.
* ``StarSpaceLayer``, ``MF``, ``StarSpaceModel`` and ``LTRWrapper`` from the
  same flax parameters (``convert.from_flax_params``), rtol 1e-6.
* The port's miner: its draws uniform (a chi-square test at a fixed seed),
  the same integers for the same ``(seed, step)`` key, a function of the
  key alone, and its views laid out as the JAX ``UniformBatchMiner``'s for
  the same draws; ``interleave_pos_neg`` as the JAX package's.
* ``regularize`` / ``Regularizer``: the penalty and its gradient with the
  filters ``kernel``, ``bias`` and a table's name, norms 1 and 2, on every
  model case of ``test_torch_ctr_models`` and on a whole ``Sequential``;
  ``convert.flax_path`` inverts ``torch_name`` on all their parameters.
* The pipeline's miner defaults and refusals, and ``PRM``'s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as scipy_stats

import torecsys_tpu.losses as JLOSS
import torecsys_tpu.metrics as JMET
import torecsys_tpu.models as JM
from torecsys_tpu import inputs as J
from torecsys_tpu.layers import StarSpaceLayer as JaxStarSpaceLayer
from torecsys_tpu.miners import BaseMiner as JaxBaseMiner
from torecsys_tpu.train.steps import interleave_pos_neg as jax_interleave
from torecsys_tpu.utils.operations import regularize as jax_regularize
from torecsys_tpu_torch import inputs as T
from torecsys_tpu_torch import losses as TLOSS
from torecsys_tpu_torch import metrics as TMET
from torecsys_tpu_torch.convert import flatten, flax_path, from_flax_params, torch_name
from torecsys_tpu_torch.layers import Regularizer, StarSpaceLayer
from torecsys_tpu_torch.miners import UniformBatchMiner, fold_in, get_miner, randint, seed_key
from torecsys_tpu_torch.models import MODELS, LTRWrapper, Sequential, get_model
from torecsys_tpu_torch.train import Pipeline
from torecsys_tpu_torch.train.steps import eval_miner_key, interleave_pos_neg, miner_key
from torecsys_tpu_torch.utils.operations import regularize
from test_torch_ctr_models import MODEL_CASES

B, K, E = 16, 4, 8
RTOL = 1e-6


def _scores(seed, shape):
    """Scores on a coarse grid (ties between rows) with some pairs equal."""
    return (np.random.default_rng(seed).integers(-6, 7, size=shape) / 4.0).astype(np.float32)


def _pairwise_inputs():
    pos = _scores(0, (B, 1))
    neg = _scores(1, (B, K))
    neg[:4, 0] = pos[:4, 0]  # the anchor's own target drawn: pos == neg
    neg[4:8, 2] = neg[4:8, 1]  # a negative drawn twice: tied maxima
    return pos, neg


def _mask():
    return (np.arange(B) % 3 != 0)


LOSS_CASES = {
    # name: (kwargs, uses the mask)
    "PointwiseLogisticLoss": ({}, False),
    "BayesianPersonalizedRankingLoss": ({}, False),
    "BayesianPersonalizedRankingLoss_masked": ({}, True),
    "HingeLoss": ({"margin": 0.5}, False),
    "HingeLoss_masked": ({}, True),
    "AdaptiveHingeLoss": ({"margin": 0.25}, False),
    "TripletLoss": ({"margin": 1.0}, False),
    "TripletLoss_soft": ({"margin": None}, False),
}


def _grads_jax(fn, *arrays):
    value, grads = jax.value_and_grad(lambda *a: fn(*a), argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    return np.asarray(value), [np.asarray(g) for g in grads]


def _grads_torch(fn, *arrays):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    value = fn(*ts)
    value.backward()
    return value.detach().numpy(), [t.grad.numpy() for t in ts]


def _hold(jax_out, torch_out):
    (jv, jg), (tv, tg) = jax_out, torch_out
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=1e-7)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_ranking_loss_and_gradient_match_the_jax_loss(case):
    kwargs, masked = LOSS_CASES[case]
    name = case.split("_")[0]
    pos, neg = _pairwise_inputs()
    mask = _mask() if masked else None
    jl, tl = JLOSS.get_loss(name, **kwargs), TLOSS.get_loss(name, **kwargs)
    _hold(_grads_jax(lambda p, n: jl(p, n, None if mask is None else jnp.asarray(mask)),
                     pos, neg),
          _grads_torch(lambda p, n: tl(p, n, None if mask is None else torch.tensor(mask)),
                       pos, neg))


@pytest.mark.parametrize("masked", [False, True])
def test_listnet_loss_and_gradient_match_the_jax_loss(masked):
    y_true = np.concatenate([np.ones((B, 1)), np.zeros((B, K))], axis=1).astype(np.float32)
    y_pred = _scores(2, (B, 1 + K))
    mask = np.random.default_rng(3).uniform(size=(B, 1 + K)) < 0.8 if masked else None
    mask_j = None if mask is None else jnp.asarray(mask)
    mask_t = None if mask is None else torch.tensor(mask)
    jl, tl = JLOSS.ListnetLoss(), TLOSS.ListnetLoss()
    assert TLOSS.ListnetLoss.groupwise is True
    _hold(_grads_jax(lambda t, p: jl(t, p, mask_j), y_true, y_pred),
          _grads_torch(lambda t, p: tl(t, p, mask_t), y_true, y_pred))


@pytest.mark.parametrize("masked", [False, True])
def test_skip_gram_loss_and_gradient_match_the_jax_loss(masked):
    rng = np.random.default_rng(4)
    content, pos = (rng.normal(size=(B, E)).astype(np.float32) for _ in range(2))
    negs = rng.normal(size=(B, K, E)).astype(np.float32)
    mask = _mask() if masked else None
    jl, tl = JLOSS.SkipGramLoss(), TLOSS.SkipGramLoss()
    _hold(_grads_jax(lambda c, p, n: jl(c, p, n, None if mask is None else jnp.asarray(mask)),
                     content, pos, negs),
          _grads_torch(lambda c, p, n: tl(c, p, n, None if mask is None else torch.tensor(mask)),
                       content, pos, negs))


@pytest.mark.parametrize("name", ["BCELoss", "BCEWithLogitsLoss", "MSELoss"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "mask"])
def test_pointwise_criteria_match_the_jax_criteria(name, reduction):
    rng = np.random.default_rng(5)
    preds = rng.uniform(0.01, 0.99, size=(B, 1)).astype(np.float32)
    targets = (rng.uniform(size=B) < 0.5).astype(np.float32)  # (B,) against (B, 1)
    kwargs = {} if reduction == "mask" else {"reduction": reduction}
    mask = _mask() if reduction == "mask" else None
    jl, tl = JLOSS.get_loss(name, **kwargs), TLOSS.get_loss(name, **kwargs)
    _hold(_grads_jax(lambda p: jl(p, jnp.asarray(targets),
                                  None if mask is None else jnp.asarray(mask)), preds),
          _grads_torch(lambda p: tl(p, torch.tensor(targets),
                                    None if mask is None else torch.tensor(mask)), preds))


def test_loss_registry_resolves_the_jax_names():
    assert set(TLOSS.LOSSES) == set(JLOSS.LOSSES)
    for name in TLOSS.LOSSES:
        assert TLOSS.get_loss(name).__class__.__name__ == name
    with pytest.raises(KeyError):
        TLOSS.get_loss("NopeLoss")


# ---- metrics ---------------------------------------------------------------

def _ranked_ids():
    rng = np.random.default_rng(6)
    rec = np.stack([rng.permutation(20)[:8] for _ in range(B)]).astype(np.int32)
    rel = rng.integers(0, 20, size=(B, 5)).astype(np.int32)
    rec[::4, 6:] = -1  # pads
    rel[1::3, 3:] = -1
    return rec, rel


@pytest.mark.parametrize("k", [1, 3, 8])
def test_map_and_mar_at_k_match_the_jax_metrics(k):
    rec, rel = _ranked_ids()
    for jf, tf in ((JMET.mean_average_precision_at_k, TMET.mean_average_precision_at_k),
                   (JMET.mean_average_recall_at_k, TMET.mean_average_recall_at_k)):
        np.testing.assert_allclose(float(tf(torch.tensor(rec), torch.tensor(rel), k)),
                                   float(jf(jnp.asarray(rec), jnp.asarray(rel), k)), rtol=RTOL)


@pytest.mark.parametrize("k", [None, 1, 4])
@pytest.mark.parametrize("exp", [True, False])
def test_dcg_idcg_ndcg_match_the_jax_metrics(k, exp):
    relevance = np.random.default_rng(7).integers(0, 4, size=(B, 6)).astype(np.float32)
    relevance[0] = 0.0  # no relevant item: IDCG 0
    for jf, tf in ((JMET.discounted_cumulative_gain, TMET.discounted_cumulative_gain),
                   (JMET.ideal_discounted_cumulative_gain,
                    TMET.ideal_discounted_cumulative_gain),
                   (JMET.normalized_discounted_cumulative_gain,
                    TMET.normalized_discounted_cumulative_gain)):
        np.testing.assert_allclose(tf(torch.tensor(relevance), k=k, exp=exp).numpy(),
                                   np.asarray(jf(jnp.asarray(relevance), k=k, exp=exp)),
                                   rtol=RTOL)


def test_mse_and_novelty_score_match_the_jax_metrics():
    rec, _ = _ranked_ids()
    occurrence = np.random.default_rng(8).integers(0, 50, size=20).astype(np.int32)
    np.testing.assert_allclose(
        float(TMET.novelty_score(torch.tensor(rec), torch.tensor(occurrence), 40)),
        float(JMET.novelty_score(jnp.asarray(rec), jnp.asarray(occurrence), 40)), rtol=RTOL)
    a, b = _scores(9, (B, 3)), _scores(10, (B, 3))
    np.testing.assert_allclose(float(TMET.mse(torch.tensor(a), torch.tensor(b))),
                               float(JMET.mse(jnp.asarray(a), jnp.asarray(b))), rtol=RTOL)


@pytest.mark.parametrize("k", [None, 2, 10])
def test_streaming_ndcg_ranks_ties_stably_as_the_jax_metric(k):
    """Two batches of lists whose scores tie often (a grid of 5 values), one
    relevant item first in each list, so a tie with it decides its rank;
    merged states equal the state of both batches."""
    jm, tm = JMET.StreamingNDCG(k=k), TMET.StreamingNDCG(k=k)
    js, ts = jm.init(), tm.init("cpu")
    parts = []
    for seed in (11, 12):
        scores = (np.random.default_rng(seed).integers(0, 5, size=(B, 1 + K)) / 4.0
                  ).astype(np.float32)
        relevance = np.zeros((B, 1 + K), np.float32)
        relevance[:, 0] = 1.0
        relevance[::5, 2] = 2.0
        js = jm.update(js, jnp.asarray(scores), jnp.asarray(relevance))
        ts = tm.update(ts, torch.tensor(scores), torch.tensor(relevance))
        parts.append(tm.update(tm.init("cpu"), torch.tensor(scores), torch.tensor(relevance)))
    np.testing.assert_allclose(float(tm.compute(ts)), float(jm.compute(js)), rtol=RTOL)
    np.testing.assert_allclose(float(tm.compute(tm.merge(*parts))), float(tm.compute(ts)),
                               rtol=RTOL)


def test_streaming_novelty_matches_the_jax_metric():
    rec, _ = _ranked_ids()
    occurrence = np.random.default_rng(13).integers(0, 50, size=20).astype(np.int32)
    jm = JMET.Novelty(occurrence=jnp.asarray(occurrence), num_users=40)
    tm = TMET.Novelty(occurrence=torch.tensor(occurrence), num_users=40)
    js, ts = jm.init(), tm.init("cpu")
    for half in (rec[:B // 2], rec[B // 2:]):
        js = jm.update(js, jnp.asarray(half))
        ts = tm.update(ts, torch.tensor(half))
    np.testing.assert_allclose(float(tm.compute(ts)), float(jm.compute(js)), rtol=RTOL)


# ---- layers and models -----------------------------------------------------

def _flax_init(module, *args):
    return module.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
                       *args)


def test_starspace_layer_matches_the_jax_layer():
    x = np.random.default_rng(14).normal(size=(B, 2, E)).astype(np.float32)
    jl = JaxStarSpaceLayer()
    want = jl.apply(_flax_init(jl, jnp.asarray(x)), jnp.asarray(x))
    got = StarSpaceLayer()(torch.tensor(x))
    assert got.shape == (B, E)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_matrix_factorization_matches_the_jax_model():
    x = np.random.default_rng(15).normal(size=(B, 2, E)).astype(np.float32)
    jm = JM.MF()
    variables = _flax_init(jm, jnp.asarray(x))
    port = from_flax_params(get_model("MF", device="cpu"), variables.get("params", {}))
    np.testing.assert_allclose(port(torch.tensor(x)).numpy(),
                               np.asarray(jm.apply(variables, jnp.asarray(x))), rtol=RTOL)


@pytest.mark.parametrize("num_neg", [1, 3])
def test_starspace_model_and_predict_match_the_jax_model(num_neg):
    agg = B * (1 + num_neg)
    rng = np.random.default_rng(16)
    ctx, tgt = (rng.normal(size=(agg, 1, E)).astype(np.float32) for _ in range(2))
    jm = JM.StarSpaceModel(embed_size=E, num_neg=num_neg)
    variables = _flax_init(jm, jnp.asarray(ctx), jnp.asarray(tgt))
    port = from_flax_params(get_model("StarSpace", device="cpu", embed_size=E, num_neg=num_neg),
                            variables.get("params", {}))
    got = port(torch.tensor(ctx), torch.tensor(tgt))
    assert got.shape == (agg, 1)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jm.apply(variables, jnp.asarray(ctx), jnp.asarray(tgt))),
                               rtol=RTOL, atol=1e-7)
    # The JAX model's ``predict`` builds its layer outside ``@compact`` and
    # raises in flax (ROADMAP section 3); its arithmetic, the layer's terms
    # summed, is taken here from the JAX layer.
    with pytest.raises(Exception, match="setup|compact"):
        jm.apply(variables, jnp.asarray(ctx[:B]), jnp.asarray(tgt[:B]), method=jm.predict)
    pair = jnp.concatenate([jnp.asarray(ctx[:B]), jnp.asarray(tgt[:B])], axis=1)
    want = jnp.sum(JaxStarSpaceLayer().apply({}, pair), axis=1, keepdims=True)
    np.testing.assert_allclose(port.predict(torch.tensor(ctx[:B]), torch.tensor(tgt[:B])).numpy(),
                               np.asarray(want), rtol=RTOL, atol=1e-7)


def test_ltr_wrapper_and_predict_match_the_jax_wrapper():
    rng = np.random.default_rng(17)
    n = 5
    pos = {"feat_inputs": rng.normal(size=(B, n, 1)).astype(np.float32),
           "emb_inputs": rng.normal(size=(B, n, E)).astype(np.float32)}
    neg = {k: (v * 0.5).astype(np.float32) for k, v in pos.items()}
    jw = JM.LearningToRankWrapper(model=JM.FM())
    jpos, jneg = ({k: jnp.asarray(v) for k, v in d.items()} for d in (pos, neg))
    variables = _flax_init(jw, jpos, jneg)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.1, variables["params"])
    inner = get_model("FM", device="cpu")
    port = from_flax_params(LTRWrapper(inner), params)
    want = jw.apply({"params": params}, jpos, jneg)
    got = port({k: torch.tensor(v) for k, v in pos.items()},
               {k: torch.tensor(v) for k, v in neg.items()})
    for key in ("pos_outputs", "neg_outputs"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]), rtol=RTOL,
                                   atol=1e-6)
    np.testing.assert_allclose(
        port.predict({k: torch.tensor(v) for k, v in pos.items()}).detach().numpy(),
        np.asarray(jw.apply({"params": params}, jpos, method=jw.predict)), rtol=RTOL, atol=1e-6)


def test_the_registry_holds_the_emb_and_ltr_models_and_prm_waits():
    """The emb and ltr models under the JAX package's names; PRM, which
    waited for the attention layers, builds (``test_torch_attention`` holds
    it to the JAX PRM)."""
    for name in ("MF", "MatrixFactorization", "StarSpace", "LTRWrapper", "PRM",
                 "PersonalizedReRanking"):
        assert name in MODELS
        assert MODELS[name].__name__ == JM.MODELS[name].__name__
    for name in ("PRM", "PersonalizedReRanking"):
        prm = get_model(name, embed_size=E, max_num_position=5, device="cpu")
        scores = prm(torch.zeros(2, 5, E))
        assert scores.shape == (2, 5)
        np.testing.assert_allclose(scores.sum(dim=1).detach().numpy(), 1.0, rtol=1e-6)


# ---- the miner -------------------------------------------------------------

def test_miner_draws_are_uniform():
    """A chi-square test of 200,000 draws over 64 rows at seed 0 and step 7."""
    high, n = 64, 200_000
    draws = randint(miner_key(0, torch.tensor(7, dtype=torch.int32)), n, high)
    assert draws.dtype == torch.int64 and int(draws.min()) >= 0 and int(draws.max()) < high
    counts = np.bincount(draws.numpy(), minlength=high)
    assert scipy_stats.chisquare(counts).pvalue > 1e-3


def test_miner_draws_depend_on_the_key_alone():
    step = torch.tensor(3, dtype=torch.int32)
    miner = UniformBatchMiner(num_negs=K)
    a = miner.draw(miner_key(0, step), B)
    assert torch.equal(a, miner.draw(miner_key(0, step.clone()), B))
    assert torch.equal(a, miner.draw(int(miner_key(0, step)), B, "cpu"))
    assert not torch.equal(a, miner.draw(miner_key(0, step + 1), B))
    assert not torch.equal(a, miner.draw(miner_key(1, step), B))
    assert not torch.equal(a, miner.draw(eval_miner_key(3), B))
    assert eval_miner_key(3) == fold_in(seed_key(0), 3)
    # the hash on Python ints and on int64 tensors gives the same integers
    keys = torch.arange(0, 2**32, 2**32 // 1000, dtype=torch.int64)
    assert fold_in(keys, 12345).tolist() == [fold_in(int(k), 12345) for k in keys]
    assert int(keys.max()) < 2**32 and int(fold_in(keys, 12345).max()) < 2**32


class ReplayMiner(JaxBaseMiner):
    """The JAX side's miner in these tests: the JAX ``UniformBatchMiner``'s
    views, with the negatives' rows given for each key it may be called
    with (the port miner's draws of the same step or evaluation batch)."""

    def __init__(self, num_negs, keys, draws):
        self.num_negs = num_negs
        self.keys = jnp.asarray(np.stack([np.asarray(k, dtype=np.uint32) for k in keys]))
        self.draws = jnp.asarray(np.stack(draws).astype(np.int32))

    def __call__(self, key, batch, target_field):
        match = jnp.all(self.keys == key[None, :], axis=1)
        neg_idx = self.draws[jnp.argmax(match)]
        target = batch[target_field]
        neg_batch = {name: (jnp.take(target, neg_idx, axis=0) if name == target_field
                            else jnp.repeat(x, self.num_negs, axis=0))
                     for name, x in batch.items()}
        return dict(batch), neg_batch


def test_miner_views_are_laid_out_as_the_jax_miners():
    rng = np.random.default_rng(18)
    batch = {"user": rng.integers(0, 50, B).astype(np.int32),
             "item": rng.integers(0, 30, B).astype(np.int32),
             "hist": rng.integers(0, 30, (B, 3)).astype(np.int32)}
    miner = get_miner("UniformBatchMiner", num_negs=K)
    key = miner_key(0, torch.tensor(0, dtype=torch.int32))
    pos_t, neg_t = miner(key, {k: torch.tensor(v) for k, v in batch.items()}, "item")
    replay = ReplayMiner(K, [np.zeros(2)], [miner.draw(key, B).numpy()])
    pos_j, neg_j = replay(jnp.zeros(2, jnp.uint32), {k: jnp.asarray(v) for k, v in batch.items()},
                          "item")
    for name in batch:
        assert np.array_equal(pos_t[name].numpy(), np.asarray(pos_j[name]))
        assert np.array_equal(neg_t[name].numpy(), np.asarray(neg_j[name]))
        assert neg_t[name].shape[0] == B * K
    agg_t = interleave_pos_neg(pos_t, neg_t, K)
    agg_j = jax_interleave(pos_j, neg_j, K)
    for name in batch:
        assert np.array_equal(agg_t[name].numpy(), np.asarray(agg_j[name]))


# ---- the regularizer -------------------------------------------------------

def _penalty_and_grads_jax(params, **kw):
    value, grads = jax.value_and_grad(lambda p: jax_regularize(p, **kw))(params)
    return float(value), {p: np.asarray(g) for p, g in flatten(grads).items()}


def _hold_penalty(port, params, **kw):
    """The port's penalty and gradient on ``port`` against the JAX
    package's on ``params``, parameter by parameter (kernels transposed)."""
    want, want_grads = _penalty_and_grads_jax(params, **kw)
    port.zero_grad(set_to_none=True)
    got = Regularizer(**kw)(port)
    named = dict(port.named_parameters())
    if isinstance(got, float):  # nothing selected
        assert want == 0.0 and got == 0.0
        return
    got.backward()
    np.testing.assert_allclose(got.item(), want, rtol=RTOL)
    for path, g in want_grads.items():
        p = named[torch_name(path)]
        if path.split("/")[-1] == "kernel":
            g = g.T
        if p.grad is None:
            assert not np.any(g), path
        else:
            np.testing.assert_allclose(p.grad.numpy(), g, rtol=RTOL, atol=1e-8, err_msg=path)


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_penalty_and_gradient_match_the_jax_regularizer_on_every_model(case):
    make_jax, kwargs, make_inputs = MODEL_CASES[case]
    jm = make_jax()
    variables = _flax_init(jm, *[a for _, a in make_inputs()])
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + np.float32(0.25), variables["params"])  # biases off 0
    port = from_flax_params(get_model(case.split("_")[0], device="cpu", **kwargs), params)
    for path in flatten(params):
        assert flax_path(torch_name(path)) == path
    for key_filter in ("kernel", "bias"):
        for norm in (1, 2):
            _hold_penalty(port, params, weight_decay=0.03, norm=norm, key_filter=key_filter)


@pytest.mark.parametrize("key_filter", ["kernel", "bias", "embedding", "schema_emb_inputs",
                                        "inputs_1"])
def test_penalty_and_gradient_reach_the_tables_as_in_the_jax_package(key_filter):
    """A whole ``Sequential``: DeepFM's fused table, and NCF's two tables in
    a container, selected by name as the JAX package selects them."""
    fields = (30, 20)
    for schema_j, schema_t, model, kwargs, batch in (
        ({"feat_inputs": J.ValueInput(fields=("d",)),
          "emb_inputs": J.MultiIndicesEmbedding(embed_size=E, field_sizes=fields,
                                                fields=("a", "b"))},
         {"feat_inputs": T.ValueInput(("d",)),
          "emb_inputs": T.MultiIndicesEmbedding(E, fields, ("a", "b"), device="cpu")},
         "DeepFM", {"deep_layer_sizes": (8,)}, {"d": np.ones(4, np.float32)}),
        ({"emb_inputs": J.StackedInput(inputs=(
              J.SingleIndexEmbedding(field_size=30, embed_size=E, fields=("a",)),
              J.SingleIndexEmbedding(field_size=20, embed_size=E, fields=("b",))))},
         {"emb_inputs": T.StackedInput([T.SingleIndexEmbedding(30, E, ("a",), device="cpu"),
                                        T.SingleIndexEmbedding(20, E, ("b",), device="cpu")])},
         "NCF", {"deep_layer_sizes": (8,)}, {}),
    ):
        batch = {"a": np.arange(4, dtype=np.int32), "b": np.arange(4, dtype=np.int32), **batch}
        jseq = JM.Sequential(inputs=J.Inputs(schema=schema_j), model=JM.get_model(model, **kwargs))
        params = _flax_init(jseq, {k: jnp.asarray(v) for k, v in batch.items()})["params"]
        params = jax.tree_util.tree_map(lambda a: np.asarray(a) + np.float32(0.25), params)
        tinputs = T.Inputs(schema_t)
        port = from_flax_params(Sequential(tinputs, get_model(model, inputs=tinputs,
                                                               device="cpu", **kwargs)), params)
        for path in flatten(params):
            assert flax_path(torch_name(path)) == path
        _hold_penalty(port, params, weight_decay=0.05, norm=2, key_filter=key_filter)


def test_regularize_takes_a_mapping_of_port_names():
    w = torch.ones(3, 2, requires_grad=True)
    got = regularize({"model.mlp.weight": w, "model.mlp.bias": torch.ones(2)}, 0.5, 2)
    assert got.item() == 3.0


# ---- the pipeline ----------------------------------------------------------

def _ltr_pipeline():
    inputs = T.Inputs({"emb_inputs": T.MultiIndicesEmbedding(E, (30, 20), ("a", "b"),
                                                             device="cpu")})
    return Pipeline(device="cpu").set_objective("ltr").set_inputs(inputs).set_model("MF")


def test_pipeline_defaults_the_miner_and_needs_the_target_field():
    with pytest.raises(ValueError, match="set_miner_target_field"):
        _ltr_pipeline().finalize()
    p = _ltr_pipeline().set_miner_target_field("b").finalize()
    assert isinstance(p.miner, UniformBatchMiner) and p.num_negs == 1
    p = _ltr_pipeline().set_miner("UniformBatchMiner", num_negs=3).set_miner_target_field("b")
    assert p.num_negs == 3 and "UniformBatchMiner" in p.summary()
    assert p.row_optimizer() is None
    with pytest.raises(ValueError, match="requires objective='ctr'"):
        p.set_sparse_embeddings(True).row_optimizer()
    with pytest.raises(ValueError, match="objective must be one of"):
        Pipeline(device="cpu").set_objective("nope")
