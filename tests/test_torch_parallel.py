"""The parallel layer against the JAX package's (``tests/test_parallel.py``):
meshes, the psum and all-to-all lookups with their gradients and overflow,
the byte model, placement and the shard-local row update.

The JAX side runs here, on the rig's virtual CPU devices (a mesh of the
first ``data * table``); the port's runs in spawned gloo worlds of CPU ranks
(``test_torch_parallel_ranks``), one world per mesh shape for the whole
module.  Lookups are held bit for bit in float32 (a psum adds exact zeros,
the all-to-all moves rows as they are); table gradients within rtol 1e-5,
as the duplicates' scatter-add runs in another order; row updates within
the single-device port's bounds (``test_torch_sparse``)."""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parallel_ranks import spawn
from torecsys_tpu.ops import sparse as jax_sparse
from torecsys_tpu.ops.embedding import pack_table as jax_pack_table
from torecsys_tpu.parallel import lookup as JL
from torecsys_tpu.parallel import make_mesh as jax_make_mesh
from torecsys_tpu.parallel.sharding import infer_param_sharding as jax_infer
from torecsys_tpu_torch.parallel import lookup as PL
from torecsys_tpu_torch.parallel.mesh import Mesh, make_mesh
from torecsys_tpu_torch.parallel.sharding import (
    infer_param_sharding,
    local_shard,
    shard_batch,
    shard_module,
    shard_params,
    unshard_module,
)

MESHES = ((1, 4), (2, 2), (4, 1))


def jax_mesh(shape):
    d, t = shape
    return jax_make_mesh(data=d, table=t, devices=jax.devices()[:d * t])


def _rng(seed):
    return np.random.default_rng(seed)


def lookup_case(case):
    """(table, ids, w, strategy, packed, capacity_factor) of a named case."""
    rng = _rng(zlib.crc32(case.encode()))
    v, e, b, k = {"unpadded": (37, 8, 8, 3), "packed": (128, 16, 16, 5),
                  "packed_unpadded": (100, 16, 16, 5), "overflow": (64, 8, 4, 8)}.get(
        case.split(":")[1], (64, 16, 16, 5))
    table = rng.normal(size=(v, e)).astype(np.float32)
    high = 16 if case.split(":")[1] == "dup" else v
    ids = rng.integers(0, high, size=(b, k)).astype(np.int32)
    if case.endswith("overflow"):
        ids = np.arange(32, dtype=np.int32).reshape(4, 8)
    w = rng.normal(size=(b, k, e)).astype(np.float32)
    strategy = case.split(":")[0]
    cf = 0.25 if case.endswith("overflow") else (8.0 if strategy == "alltoall" else 2.0)
    return table, ids, w, strategy, case.split(":")[1].startswith("packed"), cf


LOOKUP_CASES = ("psum:plain", "psum:unpadded", "psum:packed", "psum:packed_unpadded",
                "alltoall:dup", "alltoall:packed", "alltoall:packed_unpadded",
                "alltoall:overflow")

RULES = ("adam", "adagrad", "sgd")


def row_case(rule, rows, seed=3):
    """(table, slots, uids, gsum, step) in the JAX layout: a dedup of a
    random stream by the JAX package's ``dedup_sum``."""
    rng = _rng(seed)
    w = 16
    # the scales of test_torch_sparse's single-device comparison
    table = rng.normal(0, 0.01, (rows, w)).astype(np.float32)
    slots = {"adam": {"mv": np.stack([rng.normal(0, 1e-3, (rows, w)),
                                      rng.uniform(0, 1e-5, (rows, w))], axis=1).astype(np.float32)},
             "adagrad": {"v": rng.uniform(0.1, 0.2, (rows, w)).astype(np.float32)},
             "sgd": {}}[rule]
    ids = rng.integers(0, rows, size=48).astype(np.int32)
    grads = rng.normal(0, 1e-2, (48, w)).astype(np.float32)
    uids, gsum = jax_sparse.dedup_sum(jnp.asarray(ids), jnp.asarray(grads), rows)
    return table, slots, np.asarray(uids), np.asarray(gsum), 3


def jax_row_tx(rule):
    return {"adam": jax_sparse.RowAdam(learning_rate=0.01, weight_decay=1e-3),
            "adagrad": jax_sparse.RowAdagrad(learning_rate=0.05),
            "sgd": jax_sparse.RowSGD(learning_rate=0.1)}[rule]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each mesh shape's world, run once: every lookup case, and at (1, 4)
    and (2, 2) the row update of each rule at 64 (divisible) and 63 stored
    rows, and the mesh checks."""
    out = {}
    for shape in MESHES:
        tasks = [("mesh", "mesh_task", {"shape": shape})]
        for case in LOOKUP_CASES:
            table, ids, w, strategy, packed, cf = lookup_case(case)
            for shard in (True, False):
                tasks.append((f"{case}:{shard}", "lookup_task", dict(
                    mesh_shape=shape, table=table, ids=ids, w=w, strategy=strategy,
                    packed=packed, capacity_factor=cf, shard=shard)))
        if shape != (4, 1):
            for rule in RULES:
                for rows in (64, 63):
                    table, slots, uids, gsum, step = row_case(rule, rows)
                    tasks.append((f"row:{rule}:{rows}", "row_update_task", dict(
                        mesh_shape=shape, rule=rule, table=table, slots=slots, uids=uids,
                        gsum=gsum, step=step)))
        out[shape] = spawn(tmp_path_factory.mktemp(f"mesh{shape[0]}x{shape[1]}"), 4, tasks)
    return out


# ---- meshes -----------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES)
def test_make_mesh_shapes_errors_and_rank_layout(worlds, shape):
    """``make_mesh`` in a world of 4 ranks: the shapes and errors of the JAX
    function on 4 devices, and rank ``r`` at ``(r // table, r % table)``
    with its row as the table group and its column as the data group."""
    ts = shape[1]
    for r, res in enumerate(worlds[shape]):
        m = res["mesh"]
        assert m["shape"] == {"data": shape[0], "table": ts}
        assert m["coordinate"] == (r // ts, r % ts)
        assert m["table_group"] == [r // ts * ts + t for t in range(ts)]
        assert m["data_group"] == [d * ts + r % ts for d in range(shape[0])]
        assert m["default"] == {"data": 4 // ts, "table": ts}
        jm = jax_make_mesh(table=ts, devices=jax.devices()[:4])
        assert dict(jm.shape) == m["default"]
        for args, msg in m["errors"].items():
            with pytest.raises(ValueError) as e:
                jax_make_mesh(*args, devices=jax.devices()[:4])
            assert str(e.value) == msg


def test_make_mesh_without_a_process_group():
    mesh = make_mesh(device_type="cpu")
    assert mesh.shape == {"data": 1, "table": 1} and mesh.coordinate == (0, 0)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh(2, 1, device_type="cpu")


# ---- lookups ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_lookup(case, shape):
    table, ids, w, strategy, packed, cf = lookup_case(case)
    mesh = jax_mesh(shape)
    ctx = JL.LookupContext(mesh=mesh, strategy=strategy, capacity_factor=cf)
    e = table.shape[1]
    src = jax_pack_table(jnp.asarray(table)) if packed else jnp.asarray(table)
    if strategy == "psum":
        fn = ((lambda t: JL.sharded_packed_lookup(t, jnp.asarray(ids), e, ctx)) if packed
              else (lambda t: JL.sharded_lookup(t, jnp.asarray(ids), ctx)))
    else:
        fn = ((lambda t: JL.sharded_packed_lookup_alltoall(t, jnp.asarray(ids), e, ctx))
              if packed else (lambda t: JL.sharded_lookup_alltoall(t, jnp.asarray(ids), ctx)))
    def both(t):  # jitted: the eager shard_map traces for seconds
        out, vjp = jax.vjp(fn, t)
        return out, vjp(jnp.asarray(w))[0]

    out, grad = jax.jit(both)(src)
    return np.asarray(out), np.asarray(grad), table


def _port_global(results, key, shape):
    """The global output (data slices of table rank 0, which every table
    rank of a slice must equal) and the global table gradient (the data
    slices' sum; a row-sharded table's shards put back at their rows)."""
    dp, ts = shape
    outs = [[None] * ts for _ in range(dp)]
    grads = [[None] * ts for _ in range(dp)]
    for res in results:
        d, t = res[key]["coordinate"]
        outs[d][t], grads[d][t] = res[key]["out"], res[key]["grad"]
    for d in range(dp):
        for t in range(1, ts):
            np.testing.assert_array_equal(outs[d][t], outs[d][0])
    out = np.concatenate([outs[d][0] for d in range(dp)])
    sharded = results[0][key]["sharded"]
    grad = sum((np.concatenate(grads[d]) if sharded else grads[d][0]) for d in range(dp))
    if not sharded:
        for d in range(dp):
            for t in range(1, ts):
                np.testing.assert_array_equal(grads[d][t], grads[d][0])
    return out, grad


@pytest.mark.parametrize("shard", (True, False), ids=("sharded", "replica"))
@pytest.mark.parametrize("case", LOOKUP_CASES)
@pytest.mark.parametrize("shape", MESHES)
def test_lookup_matches_the_jax_lookup(worlds, shape, case, shard):
    """The port's lookup of each rank's data slice, joined, equals the JAX
    package's sharded lookup to the bit (NaN in exactly the slices that JAX
    poisons on an overflow) and its table gradient ``jax.grad``'s within
    rtol 1e-5; a row-sharded table and a full copy routed through the
    collective alike."""
    out, grad = _port_global(worlds[shape], f"{case}:{shard}", shape)
    want, want_grad, table = _jax_lookup(case, shape)
    np.testing.assert_array_equal(np.isnan(out), np.isnan(want))
    if case.endswith("overflow"):
        assert np.isnan(want).any()
        np.testing.assert_array_equal(out[~np.isnan(out)], want[~np.isnan(want)])
        return
    np.testing.assert_array_equal(out, want)
    _, ids, *_ = lookup_case(case)
    if not case.split(":")[1].startswith("packed"):
        np.testing.assert_array_equal(out, table[ids])
    np.testing.assert_allclose(grad, want_grad, rtol=1e-5, atol=1e-6)


# ---- the byte model ----------------------------------------------------------

GRID = [(m, e, cf, ts, dp) for m in (4096 * 4, 4096 * 26, 512 * 26)
        for e in (8, 16, 64) for cf in (0.5, 1.0, 2.0, 8.0) for ts, dp in ((2, 4), (4, 2), (8, 1))]


@pytest.mark.parametrize("strategy", ("psum", "alltoall", "auto"))
def test_byte_model_and_strategy_match_the_jax_functions(strategy):
    for m, e, cf, ts, dp in GRID:
        if strategy != "auto":
            assert PL.modeled_comm_mb(strategy, m, e, cf, ts, dp) == JL.modeled_comm_mb(
                strategy, m, e, cf, ts, dp)
        jctx = JL.LookupContext(mesh=jax_make_mesh(data=dp, table=ts), strategy=strategy,
                                capacity_factor=cf)
        pctx = PL.LookupContext(mesh=Mesh(dp, ts, torch.device("cpu")), strategy=strategy,
                                capacity_factor=cf)
        assert PL.resolve_strategy(pctx, m, e) == JL.resolve_strategy(jctx, m, e)
    with pytest.raises(ValueError):
        PL.modeled_comm_mb("ring", 10, 4)


# ---- placement ---------------------------------------------------------------

def _jax_specs(params, mesh, **kw):
    return jax.tree_util.tree_map(lambda s: tuple(s.spec), jax_infer(params, mesh, **kw),
                                  is_leaf=lambda x: hasattr(x, "spec"))


@pytest.mark.parametrize("shape", ((2, 4), (1, 8), (4, 2), (8, 1)))
def test_placement_decides_as_the_jax_rule(shape):
    """The mixed tree of ``test_tablewise_placement_mixed`` (a sharded, a
    small and a field-aware table, a dense kernel), and the threshold at 0."""
    params = {"big": {"embedding": np.zeros((1 << 17, 8), np.float32)},
              "small": {"embedding": np.zeros((64, 8), np.float32)},
              "fa_big": {"embedding": np.zeros((3, 1 << 17, 8), np.float32)},
              "fa_odd": {"embedding": np.zeros((3, (1 << 17) + 2, 8), np.float32)},
              "tower": {"kernel": np.zeros((8, 8), np.float32)}}
    mesh = Mesh(*shape, torch.device("cpu"))
    for kw in ({}, {"min_rows_to_shard": 0}):
        jparams = jax.tree_util.tree_map(jnp.asarray, params)
        assert infer_param_sharding(params, mesh, **kw) == _jax_specs(
            jparams, jax_mesh(shape), **kw)
    if shape[1] > 1:
        placed = shard_params(params, Mesh(*shape, torch.device("cpu")))
        assert placed["big"]["embedding"].shape == ((1 << 17) // shape[1], 8)
        assert placed["fa_big"]["embedding"].shape == (3, (1 << 17) // shape[1], 8)
        assert placed["small"]["embedding"].shape == (64, 8)


@pytest.mark.parametrize("ts,want", ((2, ("table", None)), (4, ()), (8, ())))
def test_the_bench_table_shards_at_two_and_replicates_at_four_and_eight(ts, want):
    """The bench table's 4,110,550 stored rows (32,884,400 / P = 8) divide 2
    but not 4 or 8: the rule replicates it there, and its lookups still
    route through the collective (the routing checks only the row count)."""
    params = {"inputs": {"schema_emb_inputs": {"embedding": jax.ShapeDtypeStruct(
        (4_110_550, 128), jnp.float32)}}}
    mesh = Mesh(1, ts, torch.device("cpu"))
    spec = infer_param_sharding(params, mesh)["inputs"]["schema_emb_inputs"]["embedding"]
    assert spec == want
    jspec = jax_infer(params, jax_mesh((1, ts)))["inputs"]["schema_emb_inputs"]["embedding"]
    assert tuple(jspec.spec) == want
    ctx = PL.LookupContext(mesh=mesh)
    assert PL._collective(ctx, 4_110_550)


def test_a_table_drawn_under_a_layout_holds_its_rows_of_the_one_device_draw():
    """At (1, 4), each table rank's ``shard_module`` then ``reset_parameters``
    (``Trainer.init_state``'s order) of a fused table, a bf16 one, a
    field-aware one and a sequence input's holds, bit for bit, its rows of
    the one-device draw from the same seed, and leaves the generator where
    the one-device draw does; drawn again after ``unshard_module``, the
    same."""
    from torecsys_tpu_torch.inputs import (ListIndicesEmbedding, MultiIndicesEmbedding,
                                           MultiIndicesFieldAwareEmbedding)

    def tables():
        bf16 = MultiIndicesEmbedding(4, (400, 240), ("a", "b"), device="cpu")
        bf16.set_table_dtype(torch.bfloat16)
        return torch.nn.ModuleDict({
            "fused": MultiIndicesEmbedding(4, (400, 240), ("a", "b"), device="cpu"),
            "bf16": bf16,
            "field_aware": MultiIndicesFieldAwareEmbedding(4, (400, 240), ("a", "b"),
                                                           device="cpu"),
            "sequence": ListIndicesEmbedding(64, 4, ("s",), device="cpu")})

    def drawn(module, seed):
        gen = torch.Generator().manual_seed(seed)
        module.reset_parameters(gen)
        return module.embedding.detach().clone(), torch.rand(4, generator=gen)

    whole = {name: drawn(m, 11) for name, m in tables().items()}
    for t in range(4):
        mesh = Mesh(1, 4, torch.device("cpu"))
        mesh.coordinate = (0, t)
        seq = tables()
        layouts = shard_module(seq, mesh, min_rows_to_shard=0)
        assert sorted(layouts) == [f"{name}.embedding" for name in sorted(seq)]
        for _ in range(2):
            for name, m in seq.items():
                table, after = drawn(m, 11)
                assert m.row_layout is not None and table.dtype == whole[name][0].dtype, name
                assert torch.equal(table, local_shard(whole[name][0], m.row_layout)), (name, t)
                assert torch.equal(after, whole[name][1]), name
            unshard_module(seq)
            assert all(m.embedding.is_meta and m.row_layout is None for m in seq.values())
            shard_module(seq, mesh, min_rows_to_shard=0)


def test_shard_batch_keeps_each_data_slice():
    batch = {"x": np.arange(16).reshape(8, 2), "s": np.arange(24).reshape(3, 8)}
    mesh = Mesh(4, 1, torch.device("cpu"))
    mesh.coordinate = (2, 0)
    np.testing.assert_array_equal(shard_batch({"x": batch["x"]}, mesh)["x"], batch["x"][4:6])
    np.testing.assert_array_equal(shard_batch({"s": batch["s"]}, mesh, stacked=True)["s"],
                                  batch["s"][:, 4:6])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch({"x": np.zeros((6, 1))}, mesh)


# ---- the shard-local row update ------------------------------------------------

@pytest.mark.parametrize("rows", (64, 63), ids=("divisible", "odd"))
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("shape", ((1, 4), (2, 2)))
def test_sharded_row_update_matches_the_jax_one(worlds, shape, rule, rows):
    """Each table rank's rows after ``sharded_row_update`` (a table of 63
    stored rows stays whole on every rank and takes the whole-table update,
    as the JAX function's divisibility gate leaves it) against the JAX
    package's ``sharded_row_update``, within the single-device port's
    bounds."""
    table, slots, uids, gsum, step = row_case(rule, rows)
    ctx = JL.LookupContext(mesh=jax_mesh(shape))
    want_t, want_s = jax_sparse.sharded_row_update(
        jax_row_tx(rule), jnp.asarray(table), jax.tree_util.tree_map(jnp.asarray, slots),
        jnp.asarray(uids), jnp.asarray(gsum), jnp.int32(step), ctx)
    ts = shape[1]
    parts = {}
    for res in worlds[shape]:
        r = res[f"row:{rule}:{rows}"]
        assert r["sharded"] == (rows % ts == 0)
        t = r["coordinate"][1]
        if t in parts:  # every data slice holds the same rows
            np.testing.assert_array_equal(parts[t]["table"], r["table"])
        parts[t] = r
    if rows % ts == 0:
        got_t = np.concatenate([parts[t]["table"] for t in range(ts)])
        got_s = {k: np.concatenate([parts[t]["slots"][k] for t in range(ts)]) for k in slots}
    else:
        got_t, got_s = parts[0]["table"], parts[0]["slots"]
    np.testing.assert_allclose(got_t, np.asarray(want_t), rtol=1e-6, atol=1e-7)
    for k in slots:
        np.testing.assert_allclose(got_s[k], np.asarray(want_s[k]), rtol=1e-6, atol=1e-9)
    touched = np.unique(uids[uids < rows])
    assert not np.allclose(got_t[touched], table[touched])
