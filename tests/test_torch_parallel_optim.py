"""Reductions over the whole logical table and batch under a mesh: the dense
optimizers on a row-sharded table, the regularizer's penalty and the
in-batch miner, against the JAX package's mesh Trainer (its ``jit`` runs
over global arrays, so its norms, means, maxima, penalty and draws are the
whole table's and the whole batch's).

* Lamb, Lars, Fromage, NovoGrad, SM3 and Adafactor (and Adam, elementwise,
  the control) on a dense-route DeepFM whose table is row-sharded at (2, 2)
  and (1, 4): each step from the JAX mesh Trainer's state (carried into each
  rank's shards by ``convert.from_flax_params``), its loss within rtol 1e-5
  and every parameter and optimizer state tensor after it within atol 1e-7
  + rtol 1e-6 (``test_torch_optimizers``' bounds) and 1e-5 of the tensor's
  largest magnitude (each side's own gradient rounding; the held steps
  start after a warm-up step of the JAX Trainer).  The table holds 2,048
  ids at E = 16, 256 stored rows: 128 a shard at (2, 2), 64 at (1, 4), so
  Adafactor factors it as the logical table (256, 128) is factored, not as
  a shard is (at 64 rows a shard would not be factored, at 128 it would be
  factored along the other axis).
* NoisySGD at both shapes against the single-device port (its noise is the
  port's own hash, not a JAX key's draws): the same noise at each element's
  logical position, the same steps.
* The regularizer on the table (``key_filter="embedding"``): every rank's
  loss is the JAX mesh Trainer's, the whole table's penalty.
* ``ltr`` (NCF + BPR) at (2, 2): the negatives are drawn over the global
  batch (the JAX side replays the port's global draws, as
  ``test_torch_ltr_train`` replays them); each step's loss and state, and
  ``val_ndcg@10`` from the JAX Trainer's weights.

The port runs in two spawned gloo worlds of four CPU ranks, one a mesh
shape, at once (``test_torch_parallel_ranks``)."""

import concurrent.futures
import re

import jax
import numpy as np
import pytest
import torch

from test_torch_ltr import ReplayMiner
from test_torch_parallel_ranks import assemble, build_pipeline, local_state, spawn
from test_torch_parallel_train import JaxMeshRun
from torecsys_tpu.data.sample_data import make_synthetic_ctr
from torecsys_tpu_torch import Trainer
from torecsys_tpu_torch.convert import flatten, from_flax_params, optax_fields, torch_name
from torecsys_tpu_torch.miners import UniformBatchMiner
from torecsys_tpu_torch.train.steps import eval_miner_key, miner_key

# the JAX Trainer takes WARM steps first, so that the held steps start from
# a trained optimizer state (moments, factors and accumulators away from 0,
# which the carry into the shards must place)
B, WARM, STEPS = 256, 1, 2
SHAPES = ((2, 2), (1, 4))
OPTIONS = {"min_rows_to_shard": 0}
FIELDS = (1024, 512, 256, 128, 64, 64)  # 2,048 ids: 256 stored rows at E = 16
BASE = {"fields": FIELDS, "embed": 16, "num_dense": 4, "model": "DeepFM",
        "kwargs": {"deep_layer_sizes": (16,)}, "sparse": False}
# the dense optimizers that reduce over a whole parameter, and Adam
OPTIMIZERS = {"adam": ("Adam", 1e-3), "lamb": ("lamb", 1e-2), "lars": ("lars", 1.0),
              "fromage": ("fromage", 1e-2), "novograd": ("novograd", 1e-2),
              "sm3": ("sm3", 1e-2), "adafactor": ("adafactor", 1e-2)}
SPECS = {**{name: {**BASE, "optimizer": opt} for name, opt in OPTIMIZERS.items()},
         "regularizer": {**BASE, "optimizer": ("Adam", 1e-3),
                         "regularizer": {"weight_decay": 1e-2, "key_filter": "embedding"}}}
NOISY = {**BASE, "optimizer": ("noisy_sgd", 1e-2, {"key": 3})}
STATE_RTOL, STATE_ATOL, LOSS_RTOL = 1e-6, 1e-7, 1e-5
# Beyond test_torch_optimizers' bounds (both sides there step on one
# gradient), 1e-5 of each tensor's largest magnitude: here each side takes
# its own model's gradient, summed over the batch in its own order (at
# (2, 2) over two data slices), and an element whose sum nearly cancels
# differs by up to 5e-6 of itself, which a normalizing update (novograd's
# g / ||g||) carries into its state.  The per-shard reductions this file
# holds the port against move the table and its state by 1e-3 and more.
GRAD_ROUNDING = 1e-5
# optax's field names → torch.optim.Adam's state keys
TORCH_ADAM = {"mu": "exp_avg", "nu": "exp_avg_sq"}

# ltr: NCF + BPR over one fused table of 96 users and 32 items (128 ids at
# E = 8, 8 stored rows: row-sharded at 2), a global batch of 64 split over 2
USERS, ITEMS, LTR_B, NEGS, NDCG_K = 96, 32, 64, 4, 10
LTR = {"objective": "ltr", "fields": (USERS, ITEMS), "embed": 8, "model": "NCF",
       "kwargs": {"deep_layer_sizes": (8,)}, "criterion": "BayesianPersonalizedRankingLoss",
       "num_negs": NEGS, "optimizer": ("Adam", 1e-3)}
# a ranking loss reads differences of scores: the last bias has gradient 0
# in exact arithmetic, and its value is rounding noise (test_torch_ltr_train)
SHIFT_BIAS = re.compile(r"^model/deep/output/bias$")


def batches(n=WARM + STEPS, rows=B):
    data = make_synthetic_ctr(num_rows=rows * n, field_sizes=FIELDS, num_dense=4, seed=3)
    return [{k: v[i * rows:(i + 1) * rows] for k, v in data.items()} for i in range(n)]


def interactions(n_batches, seed):
    """User → item interactions, each user preferring a cluster of items."""
    rng = np.random.default_rng(seed)
    n = LTR_B * n_batches
    u = rng.integers(0, USERS, n).astype(np.int32)
    item = np.where(rng.uniform(size=n) < 0.8, ((u * 3) % ITEMS + rng.integers(0, 3, n)) % ITEMS,
                    rng.integers(0, ITEMS, n)).astype(np.int32)
    data = {"user": u, "item": item, "label": np.ones(n, np.float32)}
    return [{k: v[i * LTR_B:(i + 1) * LTR_B] for k, v in data.items()} for i in range(n_batches)]


def ltr_miner(n_steps, n_eval):
    """The JAX side's miner: the port's draws over the global batch, for
    the JAX Trainer's keys of steps 0..n_steps and of n_eval evaluation
    batches."""
    _, rng = jax.random.split(jax.random.PRNGKey(0))
    port = UniformBatchMiner(NEGS)
    keys, draws = [], []
    for s in range(n_steps + 1):
        keys.append(jax.random.fold_in(jax.random.fold_in(rng, s), 2))
        draws.append(port.draw(miner_key(0, torch.tensor(s, dtype=torch.int32)), LTR_B))
    for i in range(n_eval):
        keys.append(jax.random.fold_in(jax.random.PRNGKey(0), i))
        draws.append(port.draw(eval_miner_key(i), LTR_B))
    return ReplayMiner(NEGS, keys, [d.numpy() for d in draws])


def jax_steps(spec, shape, feed, miner=None):
    """The JAX mesh run over ``feed``: its states before each step after the
    first WARM and after the last, and those steps' losses."""
    ref = JaxMeshRun(spec, shape, feed, OPTIONS, miner, NDCG_K)
    states, losses = [], []
    for b in feed:
        states.append(ref.state())
        losses.append(ref.step(b))
    states.append(ref.state())
    return ref, states[WARM:], losses[WARM:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX mesh runs and, in the port's two worlds at once, each run of
    the world's mesh shape from the JAX states; NoisySGD from one set of
    parameters on every shape and on one device."""
    feed = batches()
    jax_side, tasks = {}, {shape: [] for shape in SHAPES}
    for name, spec in SPECS.items():
        for shape in SHAPES:
            _, states, losses = jax_steps(spec, shape, feed)
            jax_side[(name, shape)] = {"states": states, "losses": losses}
            tasks[shape].append(((name, shape), "trainer_task", dict(
                mesh_shape=shape, spec=spec, batches=feed[WARM:], states=states[:-1],
                lookup_options=OPTIONS)))
    params0 = jax_side[("adam", SHAPES[0])]["states"][0]["params"]
    for shape in SHAPES:
        tasks[shape].append((("noisy_sgd", shape), "trainer_task", dict(
            mesh_shape=shape, spec=NOISY, batches=feed[WARM:], free_from=params0,
            lookup_options=OPTIONS)))
    ltr_feed, held = interactions(WARM + STEPS, 0), interactions(2, 1)
    ref, states, losses = jax_steps(LTR, (2, 2), ltr_feed, ltr_miner(WARM + STEPS, len(held)))
    _, rng = jax.random.split(jax.random.PRNGKey(0))
    assert np.array_equal(np.asarray(ref.t.state.rng), np.asarray(rng))
    jax_side["ltr"] = {"states": states, "losses": losses, "ndcg": ref.t.evaluate(held)}
    tasks[(2, 2)].append(("ltr", "trainer_task", dict(
        mesh_shape=(2, 2), spec=LTR, batches=ltr_feed[WARM:], states=states[:-1],
        lookup_options=OPTIONS, final_state=states[-1], eval_batches=held)))
    tasks[(2, 2)].append(("reductions", "reductions_task", dict(
        mesh_shape=(2, 2), spec=SPECS["lamb"], lookup_options=OPTIONS)))
    with concurrent.futures.ThreadPoolExecutor(len(SHAPES)) as pool:
        worlds = {shape: pool.submit(spawn, tmp_path_factory.mktemp(f"optim{shape[0]}x{shape[1]}"),
                                     4, t) for shape, t in tasks.items()}
        port = {shape: w.result() for shape, w in worlds.items()}
    single = Trainer(build_pipeline(NOISY), presort=False, log_every=10**9)
    single.init_state()
    from_flax_params(single.pipeline.sequential, params0)
    noisy = []
    for b in feed[WARM:]:
        noisy.append((float(single.train_steps([b])[0]), local_state(single)))
    return jax_side, port, noisy


def jax_opt_tensors(opt_state, port_keys):
    """``{(port parameter name, port state key): the global array}`` of a
    dense-route optax state, in the port's layout (flax kernels transposed,
    sm3's per-axis vectors in the port's axis order)."""
    fields = optax_fields(opt_state)
    count = fields.pop("count", None)
    out = {}
    for field, tree in fields.items():
        for path, leaf in flatten(tree).items():
            name, kernel = torch_name(path), path.endswith("kernel")
            if isinstance(leaf, (list, tuple)):  # sm3's mu: a vector an axis
                leaves = [(f"{field}_{j}", v) for j, v in enumerate(leaf[::-1] if kernel
                                                                    else leaf)]
            else:
                key = TORCH_ADAM.get(field, field) if "exp_avg" in port_keys[name] else field
                leaves = [(key, leaf)]
            for key, v in leaves:
                arr = np.asarray(v, np.float32)
                out[(name, key)] = arr.T if kernel else arr
    return out, count


def _atol(ref):
    return STATE_ATOL + GRAD_ROUNDING * float(np.abs(ref).max(initial=0.0))


def assert_step(states, jax_state, what, skip=None):
    """Every parameter and dense optimizer state tensor of the ranks'
    states against the JAX state, at the optimizer tests' bounds."""
    for path, ref in flatten(jax_state["params"]).items():
        if skip is not None and skip.search(path):
            continue
        ref = np.asarray(ref)
        ref = ref.T if path.endswith("kernel") else ref
        got = assemble(states, torch_name(path)).reshape(ref.shape)
        np.testing.assert_allclose(got, ref, rtol=STATE_RTOL, atol=_atol(ref),
                                   err_msg=f"{what}: {path}")
    port_keys = {n: set(s) for n, s in states[0]["opt"].items()}
    tensors, count = jax_opt_tensors(jax_state["opt_state"], port_keys)
    for name, keys in port_keys.items():
        assert keys - {"step"} == {k for n, k in tensors if n == name}, (what, name, keys)
        if count is not None:
            assert float(states[0]["opt"][name]["step"]) == int(count), (what, name)
    for (name, key), ref in tensors.items():
        if skip is not None and skip.search(name.replace(".", "/")):
            continue
        got = assemble(states, name, opt=key).reshape(ref.shape)
        np.testing.assert_allclose(got, ref, rtol=STATE_RTOL, atol=_atol(ref),
                                   err_msg=f"{what}: {name} {key}")


def _results(port, name, shape):
    return [r[(name, shape)] for r in port[shape]]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_each_step_tracks_the_jax_mesh_trainer(runs, name, shape):
    """Each step from the JAX mesh Trainer's state: the loss, every
    parameter and every optimizer state tensor, the table's shards put back
    together (a reduced state tensor, the same on every rank)."""
    jax_side, port, _ = runs
    ref, results = jax_side[(name, shape)], _results(port, name, shape)
    assert results[0]["states"][0]["layouts"]  # the table is row-sharded
    for res in results:
        assert res["losses"] == results[0]["losses"]
    np.testing.assert_allclose(results[0]["losses"], ref["losses"], rtol=LOSS_RTOL)
    for i in range(STEPS):
        assert_step([r["states"][i] for r in results], ref["states"][i + 1],
                    f"{name} {shape} step {i}")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_adafactor_factors_the_logical_table(runs, shape):
    """The table of 256 stored rows (W = 128) is factored as (256, 128) is:
    a factor of the 128 columns (a mean over every row, the same on every
    rank) and one of the rows (each rank's own), not as a shard of 128 or
    64 rows would be."""
    _, port, _ = runs
    states = [r["states"][0] for r in _results(port, "adafactor", shape)]
    name = "inputs.schema.emb_inputs.embedding"
    rows = 256 // shape[1]
    assert states[0]["params"][name].shape == (rows, 128)
    shapes = {k: v.shape for k, v in states[0]["opt"][name].items()}
    assert shapes == {"v_row": (128,), "v_col": (rows,), "v": (1,), "step": ()}
    assert states[0]["opt_layouts"][name]["v_row"] is None
    assert states[0]["opt_layouts"][name]["v_col"] == (256, shape[1], 0, 1)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_noisy_sgd_equals_the_single_device_port(runs, shape):
    """Each rank draws its shard's elements of the single-device draw, so
    the mesh takes the single-device port's steps."""
    _, port, single = runs
    results = _results(port, "noisy_sgd", shape)
    for i, (loss, want) in enumerate(single):
        got = [r["states"][i] for r in results]
        np.testing.assert_allclose(results[0]["losses"][i], loss, rtol=LOSS_RTOL)
        for name, p in want["params"].items():
            np.testing.assert_allclose(assemble(got, name).reshape(p.shape), p,
                                       rtol=STATE_RTOL, atol=STATE_ATOL,
                                       err_msg=f"{shape} step {i}: {name}")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_the_regularizer_takes_the_whole_tables_penalty(runs, shape):
    """Every rank reports the JAX mesh Trainer's loss, the whole table's
    penalty in it, and the step moves the shards as JAX moves the table."""
    jax_side, port, _ = runs
    ref, results = jax_side[("regularizer", shape)], _results(port, "regularizer", shape)
    for res in results:
        np.testing.assert_allclose(res["losses"], ref["losses"], rtol=LOSS_RTOL)
    for i in range(STEPS):
        assert_step([r["states"][i] for r in results], ref["states"][i + 1],
                    f"regularizer {shape} step {i}")


def test_ltr_draws_over_the_global_batch(runs):
    """NCF + BPR at (2, 2): each step from the JAX mesh Trainer's state,
    whose miner draws the port's negatives over the global batch: the loss
    on every rank, every parameter and the Adam moments (but the score
    shift's bias); then ``val_ndcg@10`` from its weights."""
    jax_side, port, _ = runs
    ref = jax_side["ltr"]
    results = [r["ltr"] for r in port[(2, 2)]]
    assert results[0]["states"][0]["layouts"]
    for res in results:
        np.testing.assert_allclose(res["losses"], ref["losses"], rtol=LOSS_RTOL)
    for i in range(STEPS):
        assert_step([r["states"][i] for r in results], ref["states"][i + 1],
                    f"ltr step {i}", skip=SHIFT_BIAS)
    key = f"val_ndcg@{NDCG_K}"
    for res in results:
        np.testing.assert_allclose(res["evaluate"][key], ref["ndcg"][key], atol=1e-6)


def test_the_table_group_reductions_and_an_opaque_factory(runs):
    """``Mesh.all_reduce(op="max")`` takes the table group's maximum and
    counts its bytes as ``all_reduce_max``; a named written-out optimizer
    reduces over the sharded table alone; an opaque factory's optimizer
    stays per shard, and ``init_state`` warns once, naming the table."""
    _, port, _ = runs
    for r in port[(2, 2)]:
        res = r["reductions"]
        t = r["ltr"]["coordinate"][0] * 2
        assert res["max"] == [t + 1.0, -float(t)]
        assert res["sent"] == {"all_reduce_max": 8}
        assert res["reduced"] == ["inputs.schema.emb_inputs.embedding"]
        assert res["opaque"] == "SGD"
        assert len(res["warnings"]) == 1
        assert "['inputs.schema.emb_inputs.embedding']" in res["warnings"][0]


# ---- in one process: the pieces the mesh runs rest on ----------------------

def _layout(shape, ts, t):
    from torecsys_tpu_torch.parallel.sharding import RowLayout

    if len(shape) == 2:
        return RowLayout(rows=shape[0], shards=ts, index=t)
    return RowLayout(rows=shape[0] * shape[1], shards=ts, index=t, blocks=shape[0])


@pytest.mark.parametrize("shape", [(256, 128), (3, 64, 8)], ids=["fused", "field_aware"])
def test_a_shards_noise_is_its_cut_of_the_whole_draw(shape):
    """``gaussian_noise`` at a shard's logical positions gives exactly the
    shard's elements of the single-device draw (the second uniform's
    positions after the whole tensor's count)."""
    from torecsys_tpu_torch.parallel.sharding import local_shard
    from torecsys_tpu_torch.train.optimizers import TableGroup, gaussian_noise

    count = torch.tensor(3.0)
    whole = gaussian_noise(5, count, 2, shape, "cpu")
    for t in range(4):
        layout = _layout(shape, 4, t)
        local = tuple(local_shard(whole, layout).shape)
        table = TableGroup(None, layout, local)
        assert table.shape == shape and table.numel == whole.numel()
        got = gaussian_noise(5, count, 2, local, "cpu", table.positions("cpu"), table.numel)
        assert torch.equal(got, local_shard(whole, layout))


@pytest.mark.parametrize("parts", [2, 4])
def test_a_slices_draws_are_its_run_of_the_global_draws(parts):
    """The miner of slice ``d`` of ``parts`` draws its anchors' run of the
    global batch's draws, over the global rows, and takes the negatives'
    targets from the global pool; the other fields stay the slice's."""
    miner = UniformBatchMiner(3)
    key = miner_key(0, torch.tensor(7, dtype=torch.int32))
    b = 16
    rng = np.random.default_rng(0)
    batch = {"user": torch.tensor(rng.integers(0, 50, b * parts)),
             "item": torch.tensor(rng.integers(0, 30, b * parts))}
    pos_all, neg_all = miner(key, batch, "item")
    for d in range(parts):
        part = {k: v[d * b:(d + 1) * b] for k, v in batch.items()}
        draws = miner.draw(key, b, part=(d, parts))
        assert torch.equal(draws, miner.draw(key, b * parts)[d * b * 3:(d + 1) * b * 3])
        pos, neg = miner(key, part, "item", pool=batch["item"], part=(d, parts))
        for k in batch:
            assert torch.equal(pos[k], part[k])
            assert torch.equal(neg[k], neg_all[k][d * b * 3:(d + 1) * b * 3])


@pytest.mark.parametrize("name,shape,ts,want", [
    # factored as (256, 128): a factor of the columns (reduced), one of the rows
    ("adafactor", (256, 128), 4, {"v_row": None, "v_col": 0, "v": None, "step": None}),
    # 64 logical rows: unfactored, v the parameter's shape
    ("adafactor", (64, 128), 2, {"v_row": None, "v_col": None, "v": 0, "step": None}),
    # (N, Vp, W) = (3, 256, 128): factored over Vp (the rows) and W; v_row
    # drops the rows, v_col keeps them after the block axis
    ("adafactor", (3, 256, 128), 2, {"v_row": None, "v_col": 1, "v": None, "step": None}),
    ("sm3", (256, 128), 2, {"mu_0": 0, "mu_1": None, "nu": 0}),
    # the field-aware table's row vector is one block's rows
    ("sm3", (3, 256, 8), 2, {"mu_0": None, "mu_1": 0, "mu_2": None, "nu": 1}),
    ("novograd", (256, 128), 2, {"mu": 0, "nu": None, "step": None}),
], ids=lambda v: v if isinstance(v, str) else "")
def test_state_tensors_are_classified_by_their_row_axis(name, shape, ts, want):
    """``state_row_axis`` of each state tensor of a sharded table, the
    tensors sized for the shard and factored as the logical table, and the
    layouts they take in checkpoints (``axis_layout``)."""
    from torecsys_tpu_torch.parallel.sharding import axis_layout, local_shard
    from torecsys_tpu_torch.train.optimizers import get_optimizer, state_row_axis

    layout = _layout(shape, ts, 1)
    p = torch.nn.Parameter(local_shard(torch.zeros(shape), layout).contiguous())
    opt = get_optimizer(name, lr=1e-2)([p])
    opt.reduce_over(None, {p: layout})
    axes = {k: state_row_axis(opt, p, k, v) for k, v in opt.state[p].items()}
    assert axes == want
    for k, axis in axes.items():
        lay = axis_layout(layout, axis)
        if lay is None:
            continue
        v = opt.state[p][k]
        assert v.shape[axis] == lay.shard_rows
        assert lay.blocks == (shape[0] if axis == 1 else 1)
