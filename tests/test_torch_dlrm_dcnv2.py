"""DLRM-DCNv2 in the port: the multi-hot input's pooled gather, the DCN-v2
low-rank cross, the model through the Trainer on both routes, on one device
and under gloo meshes at (1, 4) and (2, 2), the multi-hot lookup's refusal
outside the psum strategy and the shard-local table, all held to the plain
PyTorch reference of ``plain_dlrm_dcnv2.py`` (float64) at a small size:
4 fields, hots (3, 1, 5, 2), E = 8, tables of 60-2,000 rows.  Free of JAX.

The Adagrad steps are taken each from one state: before each step the
plain reference's parameters and accumulators are written into the port,
so each step's error is its own float32 rounding, not the sum of the
earlier ones.
"""

import numpy as np
import pytest
import torch

import plain_dlrm_dcnv2 as plain
from dlrm_ranks import (CFG, TABLE_PARAM, batches, logical_table, pipeline, read_state, spawn,
                        write_state)

STEPS = 3
# A float32 forward against float64 over a few layers of widths <= 40: the
# logits' rounding is some 1e-7 of their scale.
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 1e-6
# A loss of float32 terms, summed over the batch, against float64.
LOSS_RTOL = 1e-5
# One Adagrad step changes an element by lr * g / sqrt(v + g**2 + eps), at
# most lr = 0.05, and by at most lr / sqrt(eps) = 500 times the error of g
# (float32 rounding, about 1e-9 here at gradients of 1e-2 and less): the
# parameters are held to 1e-6 absolute; the accumulators, sums of squared
# float32 gradients, to 1e-5 relative.
PARAM_ATOL = 1e-6
ACC_RTOL, ACC_ATOL = 1e-5, 1e-12


def _port(sparse, seed=0):
    from torecsys_tpu_torch import Trainer

    trainer = Trainer(pipeline(sparse), seed=seed, log_every=10**9, presort=False)
    trainer.init_state()
    return trainer


def _as_torch(d):
    return {k: torch.from_numpy(np.asarray(v, dtype=np.float64)) for k, v in d.items()}


def _plain_cfg():
    return dict(field_sizes=CFG["field_sizes"], hots=CFG["hots"], num_dense=CFG["num_dense"],
                bottom=CFG["bottom"], cross_layers=CFG["cross_layers"], top=CFG["top"],
                lr=CFG["lr"], eps=CFG["eps"])


def _reference_states(seed=0):
    """The plain reference's state before each step (from the port's drawn
    initial state) and its losses and states after each."""
    start = read_state(_port(True, seed))
    p, v = _as_torch(start["p"]), _as_torch(start["v"])
    data = batches(11, STEPS)
    before, losses, after = [], [], []
    for batch in data:
        before.append({"p": {k: t.numpy() for k, t in p.items()},
                       "v": {k: t.numpy() for k, t in v.items()}})
        loss, p, v = plain.step(p, v, batch, _plain_cfg())
        losses.append(loss)
        after.append({"p": {k: t.numpy() for k, t in p.items()},
                      "v": {k: t.numpy() for k, t in v.items()}})
    return data, before, losses, after


@pytest.fixture(scope="module")
def reference():
    return _reference_states()


def _hold(state, want, where):
    for k in want["p"]:
        np.testing.assert_allclose(state["p"][k], want["p"][k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=f"{where}: parameter {k}")
        np.testing.assert_allclose(state["v"][k], want["v"][k], rtol=ACC_RTOL, atol=ACC_ATOL,
                                   err_msg=f"{where}: accumulator {k}")


# ---- the pooled gather and the cross ------------------------------------------

@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("rows,lo,hi,base", [(40, 0, 40, 0), (30, 20, 50, 20), (40, 10, 25, 0)],
                         ids=["whole", "shard", "replica_share"])
def test_pooled_gather_twin_is_plain_indexing(dtype, rows, lo, hi, base):
    from torecsys_tpu_torch.ops.embedding import bag_starts
    from torecsys_tpu_torch.ops.kernels.embedding import pooled_row_gather

    rng = np.random.default_rng(rows + lo)
    hots = (3, 1, 5, 2)
    # rows on a 1/8 grid: every partial sum is exact, whatever the order
    table = rng.integers(-64, 64, size=(rows, 8)).astype(np.float32) / 8
    ids = rng.integers(base - 10, base + rows + 10, size=(16, sum(hots)))
    got = pooled_row_gather(torch.from_numpy(table), torch.from_numpy(ids).to(dtype),
                            torch.from_numpy(bag_starts(hots)), lo, hi, base).numpy()
    want = np.zeros((16, len(hots), 8), np.float32)
    bounds = np.concatenate([[0], np.cumsum(hots)])
    for b in range(16):
        for n in range(len(hots)):
            for s in range(bounds[n], bounds[n + 1]):
                if lo <= ids[b, s] < hi:
                    want[b, n] += table[ids[b, s] - base]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("compute", [None, "bfloat16"])
def test_low_rank_cross_matches_its_equation(compute):
    from torecsys_tpu_torch.layers.ctr import LowRankCrossNetworkLayer
    from torecsys_tpu_torch.layers.precision import apply_compute_dtype

    layer = LowRankCrossNetworkLayer(2, 12, 3, device="cpu",
                                     generator=torch.Generator().manual_seed(3))
    apply_compute_dtype(layer, compute)
    x0 = torch.randn(5, 3, 4, generator=torch.Generator().manual_seed(4))
    got = layer(x0)
    flat = x0.reshape(5, -1)
    x = flat
    for i in range(2):
        v, u = getattr(layer, f"v_{i}"), getattr(layer, f"u_{i}")
        if compute is None:
            proj = (x @ v.weight.T) @ u.weight.T + u.bias
        else:  # each product rounded to bf16, the bias added in bf16
            h = (x.bfloat16() @ v.weight.bfloat16().T)
            proj = (h @ u.weight.bfloat16().T) + u.bias.bfloat16()
        x = flat * proj.float() + x
    # the same operations in the same order: the same bits
    torch.testing.assert_close(got, x.reshape(5, 3, 4), rtol=0, atol=0)


def test_model_registered_under_its_names():
    from torecsys_tpu_torch.models import DLRMDCNv2Model
    from torecsys_tpu_torch.models.base import MODELS

    assert MODELS["DLRM_DCNv2"] is DLRMDCNv2Model is MODELS["DLRMDCNv2"]


# ---- one device ---------------------------------------------------------------

def test_forward_logits_match_the_plain_reference():
    trainer = _port(True)
    batch = batches(7, 1)[0]
    state = read_state(trainer)
    want = plain.logits(_as_torch(state["p"]), batch, _plain_cfg()).numpy()
    seq = trainer.pipeline.sequential
    seq.eval()
    with torch.no_grad():
        got = seq({k: torch.from_numpy(v) for k, v in batch.items() if k != "label"}).numpy()
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_adagrad_steps_each_from_one_state(reference, sparse):
    data, before, losses, after = reference
    trainer = _port(sparse)
    assert trainer.sparse is sparse
    for t, batch in enumerate(data):
        write_state(trainer, before[t]["p"], before[t]["v"])
        loss = float(trainer.train_steps([batch])[0])
        np.testing.assert_allclose(loss, losses[t], rtol=LOSS_RTOL, err_msg=f"step {t + 1}")
        _hold(read_state(trainer), after[t], f"step {t + 1}")


def test_two_steps_a_dispatch_equal_single_steps():
    from torecsys_tpu_torch import Trainer

    data = batches(13, 4)
    runs = []
    for k in (2, 1):
        trainer = Trainer(pipeline(True), seed=2, log_every=10**9, presort=False,
                          steps_per_execution=k)
        losses = [float(x) for x in trainer.train_steps(data)]
        runs.append((losses, read_state(trainer)))
    assert runs[0][0] == runs[1][0]
    for k in runs[0][1]["p"]:
        np.testing.assert_array_equal(runs[0][1]["p"][k], runs[1][1]["p"][k])
        np.testing.assert_array_equal(runs[0][1]["v"][k], runs[1][1]["v"][k])


def test_an_id_outside_the_table_adds_nothing_and_takes_no_update(reference):
    _, before, _, _ = reference
    batch = batches(17, 1)[0]
    bad = dict(batch, cat_2=batch["cat_2"].copy())
    bad["cat_2"][:, 4] = CFG["field_sizes"][2] + 10**6  # past the whole table
    ids = torch.from_numpy(plain.global_ids(bad, CFG["field_sizes"]))
    want = plain.bag_sums(torch.from_numpy(before[0]["p"]["table"]), ids, CFG["hots"])
    states = []
    for sparse in (True, False):
        trainer = _port(sparse)
        write_state(trainer, before[0]["p"], before[0]["v"])
        module = trainer.pipeline.sequential.inputs.schema["emb_inputs"]
        with torch.no_grad():
            out = module({k: torch.from_numpy(v) for k, v in bad.items()})
        # float32 sums of at most 5 rows of N(0, 0.01^2) against float64
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-6, atol=1e-7)
        trainer.train_steps([bad])
        states.append(read_state(trainer))
    # the sparse route's sentinel row and the dense route's dropped gradient
    # leave the same table
    np.testing.assert_allclose(states[0]["p"]["table"], states[1]["p"]["table"], rtol=0,
                               atol=PARAM_ATOL)
    assert np.isfinite(states[0]["p"]["table"]).all()


def test_an_unmaterialized_table_is_drawn_as_a_materialized_one():
    from torecsys_tpu_torch.inputs import MultiHotIndicesEmbedding

    kw = dict(embed_size=8, field_sizes=CFG["field_sizes"], hots=CFG["hots"],
              fields=tuple(f"cat_{i}" for i in range(4)), device="cpu")
    lazy = MultiHotIndicesEmbedding(**kw)
    assert lazy.embedding.is_meta  # nothing allocated until it is drawn
    assert lazy.to("cpu").embedding.is_meta
    lazy.reset_parameters(torch.Generator().manual_seed(5))
    again = MultiHotIndicesEmbedding(**kw)
    again.reset_parameters(torch.Generator().manual_seed(5))
    assert lazy.embedding.device.type == "cpu" and lazy.embedding.dtype == torch.float32
    assert tuple(lazy.embedding.shape) == lazy.global_shape
    torch.testing.assert_close(lazy.embedding, again.embedding, rtol=0, atol=0)
    total = sum(CFG["field_sizes"])
    table = lazy.embedding.detach().reshape(-1, 8)
    assert float(table[total:].abs().sum()) == 0.0  # the padding
    assert float(table[:total].abs().amax(dim=1).min()) > 0.0  # every row drawn


def test_tracer_reports_the_pool_span_and_the_counts():
    trainer = _port(True)
    trainer.set_tracing(True)
    data = batches(19, 2)
    trainer.train_steps(data)
    report = trainer.trace_report()
    assert "pool" in report["span_ms"] and "lookup" in report["span_ms"]
    counts = report["counts"]
    assert counts["ids"] == CFG["batch"] * sum(CFG["hots"])
    assert counts["bags"] == CFG["batch"] * len(CFG["hots"])
    assert counts["collective_bytes"] == 0  # one device: no collective
    ids = np.stack([plain.global_ids(b, CFG["field_sizes"]) for b in data])
    assert counts["touched_rows"] == np.mean([len(np.unique(i // 16)) for i in ids])


# ---- gloo meshes ------------------------------------------------------------

@pytest.fixture(scope="module")
def worlds(tmp_path_factory, reference):
    data, before, _, _ = reference
    out = {}
    for shape in ((1, 4), (2, 2)):
        tasks = [(f"held_{route}", "held_steps_task",
                  dict(mesh_shape=shape, sparse=route == "sparse", batches=data, states=before))
                 for route in ("sparse", "dense")]
        tasks.append(("init", "init_task", dict(mesh_shape=shape, seed=0)))
        out[shape] = spawn(tmp_path_factory.mktemp(f"dlrm_{shape[0]}x{shape[1]}"), 4, tasks)
    out["refused"] = spawn(tmp_path_factory.mktemp("dlrm_refused"), 2, [
        (s, "refused_task", dict(strategy=s)) for s in ("alltoall", "auto")])
    return out


def _assembled(ranks, key, t):
    """The global state after step ``t`` from the ranks' records."""
    parts = {}
    for rank in ranks:
        st = rank[key]["states"][t]
        parts.setdefault(st["first"], st)
    first = sorted(parts)
    p = {k: v for k, v in parts[0]["p"].items() if k != "table"}
    v = {k: a for k, a in parts[0]["v"].items() if k != "table"}
    p["table"] = np.concatenate([parts[f]["p"]["table"] for f in first])
    v["table"] = np.concatenate([parts[f]["v"]["table"] for f in first])
    total = sum(CFG["field_sizes"])
    return {"p": {**p, "table": p["table"][:total]}, "v": {**v, "table": v["table"][:total]}}


@pytest.mark.parametrize("route", ["sparse", "dense"])
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_mesh_steps_each_from_one_state(worlds, reference, shape, route):
    _, _, losses, after = reference
    ranks = worlds[shape]
    key = f"held_{route}"
    for t in range(STEPS):
        for rank in ranks:
            np.testing.assert_allclose(rank[key]["losses"][t], losses[t], rtol=LOSS_RTOL)
        _hold(_assembled(ranks, key, t), after[t], f"{shape} {route} step {t + 1}")
        for rank in ranks:  # every rank holds the same replicated parameters
            for k, a in rank[key]["states"][t]["p"].items():
                if k != "table":
                    np.testing.assert_array_equal(a, ranks[0][key]["states"][t]["p"][k])


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_shard_local_table_is_the_one_device_table(worlds, shape):
    whole = logical_table(_port(True, seed=0))
    ts = shape[1]
    stored = whole["shape"][0]
    for rank in worlds[shape]:
        init = rank["init"]
        assert init["shape"] == (stored // ts, whole["shape"][1])  # its own rows alone
        n = init["rows"].shape[0]
        np.testing.assert_array_equal(init["rows"], whole["rows"][init["first"]:init["first"] + n])


@pytest.mark.parametrize("strategy", ["alltoall", "auto"])
def test_multi_hot_lookup_refused_outside_psum(worlds, strategy):
    for rank in worlds["refused"]:
        assert rank[strategy] is not None and repr(strategy) in rank[strategy]
        assert "psum" in rank[strategy]


def test_the_table_parameter_is_named_as_the_benchmark_writes_it():
    trainer = _port(True)
    assert TABLE_PARAM in dict(trainer.pipeline.sequential.named_parameters())


def test_evaluate_and_predict_score_the_plain_logits():
    trainer = _port(True)
    data = batches(23, 2)
    state = read_state(trainer)
    want = [torch.sigmoid(plain.logits(_as_torch(state["p"]), b, _plain_cfg())).numpy()
            for b in data]
    got = trainer.predict(data[0]).numpy()
    np.testing.assert_allclose(got.reshape(-1), want[0].reshape(-1), rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL)
    metrics = trainer.evaluate(data)
    assert set(metrics) >= {"val_auc", "val_logloss"}
    labels = np.concatenate([b["label"] for b in data])
    probs = np.concatenate([w.reshape(-1) for w in want])
    logloss = -np.mean(labels * np.log(probs) + (1 - labels) * np.log(1 - probs))
    # the float32 scores' rounding, as the logits' (LOGIT_RTOL)
    np.testing.assert_allclose(metrics["val_logloss"], logloss, rtol=LOGIT_RTOL)
