"""The Trainer under a mesh against the JAX package's mesh Trainer
(``tests/test_parallel.py``'s train-step parities): FM under sgd (the dense
route), DeepFM under Adam on the sparse route at (2, 2) and (1, 4), the
all-to-all and auto strategies, the field-aware table, and the all-to-all
overflow: its actionable error, its recovery and its poisoned slices.

Each step starts from the JAX mesh Trainer's state (carried into each
rank's shards by ``convert.from_flax_params``): the losses are held within
rtol 1e-5 and every parameter after the step as ``test_torch_train``
holds them.  The port runs in two spawned gloo worlds of four CPU ranks,
one per mesh shape (``test_torch_parallel_ranks``)."""

import re

import jax
import numpy as np
import pytest

from test_torch_parallel_ranks import assemble, spawn
from torecsys_tpu import inputs as jax_inputs
from torecsys_tpu.data.sample_data import make_synthetic_ctr
from torecsys_tpu.parallel import lookup as JL
from torecsys_tpu.parallel import make_mesh as jax_make_mesh
from torecsys_tpu.train import Pipeline as JaxPipeline
from torecsys_tpu.train import Trainer as JaxTrainer
from torecsys_tpu_torch.convert import flatten, torch_name

B, STEPS = 256, 4
DEEPFM_FIELDS = (1000, 500, 200, 100, 64, 24)  # 236 stored rows: shards at 2 and 4
SPECS = {
    "fm_sgd": {"fields": (64, 32), "embed": 8, "num_dense": 2, "model": "FM",
               "optimizer": ("sgd", 0.1)},
    "deepfm": {"fields": DEEPFM_FIELDS, "embed": 16, "num_dense": 4, "model": "DeepFM",
               "kwargs": {"deep_layer_sizes": (32, 16)}, "optimizer": ("Adam", 1e-3),
               "sparse": True},
    "field_aware": {"fields": (24, 16, 8), "embed": 4, "num_dense": 0, "model": "DeepFFM",
                    "kwargs": {"num_fields": 3, "deep_layer_sizes": (8,)},
                    "optimizer": ("Adam", 0.01), "sparse": True, "table": "field_aware"},
    "overflow": {"fields": (4096,), "embed": 8, "num_dense": 1, "model": "FM",
                 "optimizer": ("Adam", 0.01)},
    # the CIN's BatchNorm: its statistics over the global batch at (2, 2)
    "xdeepfm": {"fields": DEEPFM_FIELDS, "embed": 8, "num_dense": 4, "model": "xDeepFM",
                "kwargs": {"embed_size": 8, "num_fields": len(DEEPFM_FIELDS),
                           "cin_layer_sizes": (6, 6), "deep_layer_sizes": (8,)},
                "optimizer": ("Adam", 1e-3), "sparse": True},
}
# (name, spec, mesh shape, lookup options)
RUNS = (
    ("fm_sgd", "fm_sgd", (2, 2), {"min_rows_to_shard": 0}),
    ("fm_sgd", "fm_sgd", (1, 4), {"min_rows_to_shard": 0}),
    ("deepfm", "deepfm", (2, 2), {"min_rows_to_shard": 0}),
    ("deepfm", "deepfm", (1, 4), {"min_rows_to_shard": 0}),
    ("alltoall", "deepfm", (2, 2), {"min_rows_to_shard": 0, "strategy": "alltoall",
                                    "capacity_factor": 8.0}),
    ("auto", "deepfm", (2, 2), {"min_rows_to_shard": 0, "strategy": "auto"}),
    ("field_aware", "field_aware", (2, 2), {"min_rows_to_shard": 0}),
    ("xdeepfm", "xdeepfm", (2, 2), {"min_rows_to_shard": 0}),
)
# The CIN's biases before its BatchNorm: gradient 0 in exact arithmetic,
# rounding noise that Adam scales to steps of up to lr (as
# test_torch_field_aware.DEAD_PARAMS); their values are not compared.
DEAD_PARAMS = re.compile(r"(^|/)cin/bias_\d+$")
OVERFLOW_OPTIONS = {"min_rows_to_shard": 0, "strategy": "alltoall", "capacity_factor": 0.25}


def jax_mesh(shape):
    d, t = shape
    return jax_make_mesh(data=d, table=t, devices=jax.devices()[:d * t])


def batches(spec, n=STEPS, rows=B):
    data = make_synthetic_ctr(num_rows=rows * n, field_sizes=spec["fields"],
                              num_dense=max(1, spec["num_dense"]), seed=0)
    return [{k: v[i * rows:(i + 1) * rows] for k, v in data.items()} for i in range(n)]


def jax_pipeline(spec, miner=None):
    """The JAX pipeline of a ``test_torch_parallel_ranks.build_pipeline``
    spec; an ``ltr`` spec mines with ``miner``."""
    fields = spec["fields"]
    if spec.get("objective", "ctr") != "ctr":
        table = jax_inputs.MultiIndicesEmbedding(embed_size=spec["embed"], field_sizes=fields,
                                                 fields=("user", "item"))
        name, lr = spec["optimizer"]
        return (JaxPipeline().set_objective(spec["objective"])
                .set_inputs(jax_inputs.Inputs(schema={"emb_inputs": table}))
                .set_model(spec["model"], **spec.get("kwargs", {}))
                .set_criterion(spec["criterion"]).set_optimizer(name, lr=lr)
                .set_miner(miner).set_miner_target_field("item").set_target_fields("label"))
    cats = tuple(f"cat_{i}" for i in range(len(fields)))
    schema = {}
    if spec["num_dense"]:
        schema["feat_inputs"] = jax_inputs.ValueInput(
            fields=tuple(f"dense_{j}" for j in range(spec["num_dense"])))
    if spec.get("table") == "field_aware":
        schema["field_emb_inputs"] = jax_inputs.MultiIndicesFieldAwareEmbedding(
            embed_size=spec["embed"], field_sizes=fields, fields=cats)
    else:
        schema["emb_inputs"] = jax_inputs.MultiIndicesEmbedding(
            embed_size=spec["embed"], field_sizes=fields, fields=cats)
    name, lr, *kw = spec["optimizer"]
    pipe = (JaxPipeline().set_objective("ctr").set_inputs(jax_inputs.Inputs(schema=schema))
            .set_model(spec["model"], **spec.get("kwargs", {}))
            .set_criterion("BCEWithLogitsLoss").set_optimizer(name, lr=lr, **(kw[0] if kw else {}))
            .set_sparse_embeddings(spec.get("sparse")).set_target_fields("label"))
    if spec.get("regularizer"):
        pipe.set_regularizer(**spec["regularizer"])
    return pipe


class JaxMeshRun:
    """The JAX Trainer under a mesh, one batch a step (presorted where its
    rule presorts: a sparse route on an unsplit data axis)."""

    def __init__(self, spec, shape, feed, options, miner=None, ndcg_k=10):
        self.t = JaxTrainer(jax_pipeline(spec, miner), mesh=jax_mesh(shape), prefetch=0, seed=0,
                            lookup_options=dict(options), log_every=10**9, ndcg_k=ndcg_k)
        self.t.init_state(feed[0])
        self.t._setup_presorter()
        self.t._build_steps()

    def state(self):
        return {"params": jax.device_get(self.t.state.params),
                "opt_state": jax.device_get(self.t.state.opt_state),
                "batch_stats": jax.device_get(self.t.state.batch_stats)}

    def step(self, batch):
        if self.t._presorter is not None:
            batch = self.t._presorter(batch)
        placed = self.t._place_batch(batch)
        with self.t._trace_contexts():
            self.t.state, logs = self.t._train_step_fn(self.t.state, placed)
        return float(logs["loss"])


def jax_overflow(recovery, feed):
    """The JAX run of the overflow test: its error or metrics, the
    recovery's actions in order, and the capacity factor it ended at."""
    actions = []
    orig = JaxTrainer._recover_lookup

    def record(self):
        action = orig(self)
        actions.append(action)
        return action

    t = JaxTrainer(jax_pipeline(SPECS["overflow"]), mesh=jax_mesh((2, 2)), log_every=1,
                   lookup_options=dict(OVERFLOW_OPTIONS), lookup_recovery=recovery)
    JaxTrainer._recover_lookup = record
    try:
        out = t.fit(lambda: iter(feed), max_epochs=1)
    except RuntimeError as e:
        out = f"{type(e).__name__}: {e}"
    finally:
        JaxTrainer._recover_lookup = orig
    return out, [a for a in actions if a], t.lookup_options["capacity_factor"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX runs (each step's state before and after), then the port's
    two worlds: every run of its mesh shape from the JAX states, and at
    (2, 2) the overflow tasks."""
    jax_side, tasks = {}, {(2, 2): [], (1, 4): []}
    for name, spec_name, shape, options in RUNS:
        spec = SPECS[spec_name]
        feed = batches(spec)
        ref = JaxMeshRun(spec, shape, feed, options)
        states, losses = [], []
        for b in feed:
            states.append(ref.state())
            losses.append(ref.step(b))
        states.append(ref.state())
        jax_side[(name, shape)] = {"states": states, "losses": losses,
                                   "presorted": ref.t._presorter is not None,
                                   "predict": np.asarray(ref.t.predict(feed[0])),
                                   "evaluate": ref.t.evaluate(feed)}
        tasks[shape].append(((name, shape), "trainer_task", dict(
            mesh_shape=shape, spec=spec, batches=feed, states=states[:-1],
            lookup_options=options, final_state=states[-1])))
    planted = batches(SPECS["overflow"], n=1)
    for recovery in (False, True):
        tasks[(2, 2)].append((("overflow", recovery), "trainer_task", dict(
            mesh_shape=(2, 2), spec=SPECS["overflow"], batches=[], fit_batches=planted,
            lookup_options=OVERFLOW_OPTIONS, lookup_recovery=recovery)))
        jax_side[("overflow", recovery)] = jax_overflow(recovery, planted)
    tasks[(2, 2)].append(("poison", "poison_task", dict(
        mesh_shape=(2, 2), spec=SPECS["overflow"], batch=planted[0],
        lookup_options=OVERFLOW_OPTIONS)))
    port = {shape: spawn(tmp_path_factory.mktemp(f"train{shape[0]}x{shape[1]}"), 4, t)
            for shape, t in tasks.items()}
    return jax_side, port, planted


def _assert_state_close(states, jax_state, spec, step):
    """Every parameter (and on the sparse route the row slots) against the
    JAX state, as ``test_torch_train._assert_params_close`` holds them:
    atol 1e-6 (1e-3 of lr; but :data:`DEAD_PARAMS`); the moments within
    1e-4 of their largest; the running statistics within rtol 1e-5, as
    ``test_torch_field_aware.assert_state_close`` holds them."""
    for path, ref in flatten(jax_state["batch_stats"] or {}).items():
        np.testing.assert_allclose(states[0]["buffers"][torch_name(path)], np.asarray(ref),
                                   rtol=1e-5, atol=1e-6, err_msg=f"step {step}: {path}")
    assert len(states[0]["buffers"]) == len(flatten(jax_state["batch_stats"] or {}))
    for path, ref in flatten(jax_state["params"]).items():
        if DEAD_PARAMS.search(path):
            continue
        ref = np.asarray(ref)
        got = assemble(states, torch_name(path))
        if path.endswith("kernel"):
            ref = ref.T
        np.testing.assert_allclose(got.reshape(ref.shape), ref, rtol=0, atol=1e-6,
                                   err_msg=f"step {step}: {path}")
    for path, slots in jax_state["opt_state"].get("sparse", {}).items() if isinstance(
            jax_state["opt_state"], dict) else ():
        for k, ref in slots.items():
            ref = np.asarray(ref)
            got = assemble(states, torch_name(path), k).reshape(ref.shape)
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max() + 1e-12,
                                       err_msg=f"step {step}: {path} {k}")


@pytest.mark.parametrize("name,shape", [(r[0], r[2]) for r in RUNS if r[0] != "xdeepfm"],
                         ids=[f"{r[0]}-{r[2][0]}x{r[2][1]}" for r in RUNS
                              if r[0] != "xdeepfm"])
def test_each_step_tracks_the_jax_mesh_trainer(runs, name, shape):
    jax_side, port, _ = runs
    ref = jax_side[(name, shape)]
    results = [r[(name, shape)] for r in port[shape]]
    spec = SPECS[dict((r[0], r[1]) for r in RUNS)[name]]
    for res in results:  # every rank reports the global batch's loss
        assert res["losses"] == results[0]["losses"]
    np.testing.assert_allclose(results[0]["losses"], ref["losses"], rtol=1e-5)
    for i in range(STEPS):
        _assert_state_close([r["states"][i] for r in results], ref["states"][i + 1], spec, i)
    # the table is row-sharded where the rule shards it
    layouts = results[0]["states"][0]["layouts"]
    assert bool(layouts) == (name != "fm_sgd" or shape[1] == 2), layouts


def test_batchnorm_statistics_span_the_global_batch(runs):
    """xDeepFM's CIN BatchNorm at (2, 2): each rank normalizes with the
    global batch's statistics (``parallel.lookup.data_mean``), so each step
    from the JAX mesh Trainer's state gives the single-device port's loss,
    running statistics and parameters; the losses also the JAX mesh
    Trainer's.  The parameters are held to the single-device port's, not to
    JAX's: from this run's fourth state the JAX step moves 82 table
    elements 2.5e-4 with the CIN's pre-BatchNorm biases (2.8e-3 there, over
    a variance near 7e-9), which cancel in exact arithmetic and move the
    port's by 2e-8: the JAX package's float32 ``E[x^2] - E[x]^2`` cancels
    (``ROADMAP.md`` §3, PR 15)."""
    from test_torch_parallel_ranks import build_pipeline, local_state
    from torecsys_tpu_torch import Trainer
    from torecsys_tpu_torch.convert import from_flax_params

    jax_side, port, _ = runs
    ref = jax_side[("xdeepfm", (2, 2))]
    results = [r[("xdeepfm", (2, 2))] for r in port[(2, 2)]]
    feed = batches(SPECS["xdeepfm"])
    for i, st in enumerate(ref["states"][:-1]):
        single = Trainer(build_pipeline(SPECS["xdeepfm"]), presort=False)
        single.init_state()
        from_flax_params(single.pipeline.sequential, st["params"], st["opt_state"],
                         single.state, batch_stats=st["batch_stats"])
        loss = float(single.train_steps([feed[i]])[0])
        np.testing.assert_allclose(results[0]["losses"][i], loss, rtol=1e-5)
        want = local_state(single)
        got = [r["states"][i] for r in results]
        for name, b in want["buffers"].items():
            np.testing.assert_allclose(got[0]["buffers"][name], b, rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i}: {name}")
        for name, p in want["params"].items():
            if DEAD_PARAMS.search(name.replace(".", "/")):
                continue
            np.testing.assert_allclose(assemble(got, name).reshape(p.shape), p, rtol=0,
                                       atol=1e-6, err_msg=f"step {i}: {name}")
        np.testing.assert_allclose(results[0]["losses"][i], ref["losses"][i], rtol=1e-5)


@pytest.mark.parametrize("name,shape", [("deepfm", (2, 2)), ("deepfm", (1, 4)),
                                        ("fm_sgd", (2, 2)), ("alltoall", (2, 2))])
def test_predict_and_evaluate_give_the_global_batch(runs, name, shape):
    """From the JAX mesh Trainer's last state every rank's ``predict``
    returns the whole batch's scores and ``evaluate`` the whole loader's
    AUC and logloss, as the JAX package's mesh Trainer does (scores and
    logloss within rtol 1e-5; the AUC's histogram counts exactly)."""
    jax_side, port, _ = runs
    ref = jax_side[(name, shape)]
    for r in port[shape]:
        res = r[(name, shape)]
        np.testing.assert_allclose(res["predict"], ref["predict"], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(res["evaluate"]["val_logloss"],
                                   ref["evaluate"]["val_logloss"], rtol=1e-5)
        np.testing.assert_allclose(res["evaluate"]["val_auc"], ref["evaluate"]["val_auc"],
                                   rtol=1e-5)


def test_presort_runs_only_where_the_jax_rule_runs_it(runs):
    jax_side, port, _ = runs
    for shape in ((2, 2), (1, 4)):
        got = {r[("deepfm", shape)]["presorted"] for r in port[shape]}
        assert got == {jax_side[("deepfm", shape)]["presorted"]} == {shape[0] == 1}


def test_overflow_without_recovery_raises_an_actionable_error(runs):
    jax_side, port, _ = runs
    for r in port[(2, 2)]:
        res = r[("overflow", False)]
        assert res["error"].startswith("LookupOverflowSuspected")
        assert "capacity_factor" in res["error"] and "psum" in res["error"]
        assert res["recoveries"] == []
    want, actions, _ = jax_side[("overflow", False)]
    assert want.startswith("LookupOverflowSuspected") and actions == []


def test_overflow_recovery_takes_the_jax_actions_in_order(runs):
    jax_side, port, _ = runs
    want, actions, cf = jax_side[("overflow", True)]
    assert np.isfinite(want["train_loss"]) and actions
    for r in port[(2, 2)]:
        res = r[("overflow", True)]
        assert "error" not in res, res.get("error")
        assert res["recoveries"] == actions
        assert np.isfinite(res["metrics"]["train_loss"])
        assert res["capacity_factor"] == cf


def test_overflow_poisons_the_slices_jax_poisons(runs):
    """The planted stream (every id in one table rank's rows) overflows the
    all-to-all at factor 0.25: the step's loss is NaN on every rank, and the
    lookup is NaN in exactly the slices of the JAX package's."""
    import jax.numpy as jnp

    jax_side, port, planted = runs
    batch = planted[0]
    mesh = jax_mesh((2, 2))
    ctx = JL.LookupContext(mesh=mesh, **{k: v for k, v in OVERFLOW_OPTIONS.items()
                                          if k != "min_rows_to_shard"}, min_rows_to_shard=0)
    params = JaxTrainer(jax_pipeline(SPECS["overflow"]), mesh=mesh).init_state(batch).params
    table = params["inputs"]["schema_emb_inputs"]["embedding"]
    want = np.asarray(JL.sharded_packed_lookup_alltoall(
        table, jnp.asarray(batch["cat_0"][:, None]), 8, ctx))
    rows = [None, None]
    for r in port[(2, 2)]:
        res = r["poison"]
        assert np.isnan(res["loss"])
        d, t = res["coordinate"]
        if rows[d] is not None:
            np.testing.assert_array_equal(np.isnan(rows[d]), np.isnan(res["rows"]))
        rows[d] = res["rows"]
    got = np.concatenate(rows)
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
