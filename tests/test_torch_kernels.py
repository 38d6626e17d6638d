"""The port's sparse-update kernels (plain versions, on the CPU) against the
JAX package's Pallas kernels run in interpret mode, on the same inputs.

Gradients are drawn on a 2^-10 grid, so every partial segment sum is exact
in float32 and the comparison checks the widening and segmentation, not
the order of summation.  Tolerance: atol 1e-6.

The sweep streams (a Zipf-skewed stream, one segment, all distinct, segments
laid on the CUDA kernels' tile edges, M = 1) fix the contract that
``chip_smoke.py`` holds the card's segment sums to: grid grads bit-identical,
real-valued grads within ``(L - 1) * 2^-24 * sum|g|`` of a float64 sum over a
segment of L positions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torecsys_tpu.ops.pallas.sparse_update import TILE_P
from torecsys_tpu.ops.pallas.sparse_update import fused_rowwise_update as jax_update
from torecsys_tpu.ops.pallas.sparse_update import sorted_widen_segment_sum as jax_segsum
from torecsys_tpu_torch.ops.kernels import sparse_update as K
from torecsys_tpu_torch.ops.kernels.sparse_update import SEGSUM_TILE, SEGSUM_WARPS

ATOL = 1e-6
SWEEP_STREAMS = ["zipf", "one segment", "distinct", "tile edges", "M=1"]
SWEEP_M = 9 * SEGSUM_TILE * SEGSUM_WARPS  # one period of the tile-edge stream


def _grid_normal(rng, shape):
    return (np.round(rng.normal(size=shape) * 1024) / 1024).astype(np.float32)


def _segments(ids, pack):
    hi = ids // pack
    lo = (ids % pack).astype(np.int32)
    first = np.concatenate([[True], hi[1:] != hi[:-1]])
    seg = (np.cumsum(first) - 1).astype(np.int32)
    return hi, lo, seg, first


def _check_segsum(ids, g, pack):
    _, lo, seg, _ = _segments(ids, pack)
    ref = np.asarray(jax_segsum(jnp.asarray(g), jnp.asarray(lo), jnp.asarray(seg), pack,
                                interpret=True))
    got = K.widen_segment_sum(torch.from_numpy(g), torch.from_numpy(lo),
                              torch.from_numpy(seg), pack)
    assert got.shape == ref.shape == (ids.shape[0], pack * g.shape[1])
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    assert not got[seg[-1] + 1:].any()  # rows past the last segment are zero


@pytest.mark.parametrize("pack", [1, 2, 4, 8])
def test_widen_segment_sum_random_ids(pack):
    rng = np.random.default_rng(pack)
    m, e = 2 * TILE_P + 512, 16  # three tiles, the last one padded
    ids = np.sort(rng.integers(0, 700 * pack, m)).astype(np.int32)
    _check_segsum(ids, _grid_normal(rng, (m, e)), pack)


@pytest.mark.parametrize("pack", [1, 2, 4, 8])
def test_widen_segment_sum_segment_across_tile_boundary(pack):
    """One stored row spans positions TILE_P-40 .. TILE_P+40, another spans a
    whole tile and more: both cross the JAX kernel's tile boundaries."""
    rng = np.random.default_rng(10 + pack)
    e = 16
    head = np.sort(rng.integers(0, 50 * pack, TILE_P - 40))
    cross = np.full(80, 60 * pack) + rng.integers(0, pack, 80)
    long_run = np.full(TILE_P + 300, 70 * pack) + rng.integers(0, pack, TILE_P + 300)
    tail = np.sort(rng.integers(71 * pack, 200 * pack, 200))
    ids = np.concatenate([head, np.sort(cross), np.sort(long_run), tail]).astype(np.int32)
    _check_segsum(ids, _grid_normal(rng, (ids.shape[0], e)), pack)


def test_widen_segment_sum_single_segment():
    rng = np.random.default_rng(3)
    m, e, pack = TILE_P, 16, 8
    ids = np.sort(rng.integers(0, pack, m)).astype(np.int32)
    _check_segsum(ids, _grid_normal(rng, (m, e)), pack)


def sweep_segments(stream, rng, m=SWEEP_M):
    """Segment ids (int32, nondecreasing, dense from 0) of a sweep stream.
    "tile edges": segments of T-1, T, T+1 and 2T+1 positions each start on a
    warp-tile edge (T = SEGSUM_TILE), and the same lengths in block tiles on
    a block-tile edge, with fillers between, as ``chip_smoke.py`` lays them."""
    if stream == "zipf":  # the bench's skew: Zipf(1.2) ids, capped at 100 rows
        ids = np.sort(np.minimum(rng.zipf(1.2, m) - 1, 99))
        return (np.cumsum(np.r_[True, ids[1:] != ids[:-1]]) - 1).astype(np.int32)
    if stream == "one segment":
        return np.zeros(m, np.int32)
    if stream == "distinct":
        return np.arange(m, dtype=np.int32)
    if stream == "tile edges":
        t, bt = SEGSUM_TILE, SEGSUM_TILE * SEGSUM_WARPS
        edges = [t - 1, 1, t, t + 1, t - 1, 2 * t + 1, t - 1, t,
                 bt - 1, 1, bt, bt + 1, bt - 1, 2 * bt + 1, bt - 1, bt]
        lens = np.tile(edges, -(-m // sum(edges)))
        return np.repeat(np.arange(lens.size), lens)[:m].astype(np.int32)
    assert stream == "M=1"
    return np.zeros(1, np.int32)


def assert_within_float64_bound(got, ref64, abs64, seg):
    """Each element within (L - 1) * 2^-24 * sum|g| of the float64 sum over
    its segment of L positions (rows past the last segment: exactly 0)."""
    lengths = np.bincount(seg, minlength=got.shape[0])
    limit = np.maximum(lengths - 1, 0)[:, None] * 2.0**-24 * abs64
    assert (np.abs(got.astype(np.float64) - ref64) <= limit).all()


def _widen64(g, lo, seg, pack):
    m, e = g.shape
    wide = np.zeros((m, pack, e))
    wide[np.arange(m), lo] = g
    out = np.zeros((m, pack * e))
    np.add.at(out, seg, wide.reshape(m, pack * e))
    return out


@pytest.mark.parametrize("pack", [1, 8])
@pytest.mark.parametrize("stream", SWEEP_STREAMS)
def test_widen_segment_sum_sweep_streams(stream, pack):
    rng = np.random.default_rng(20 + pack)
    seg = sweep_segments(stream, rng)
    m, e = seg.shape[0], 16
    # slots ascending inside each stored row, as sorted ids give them
    lo = (np.sort(seg.astype(np.int64) * pack + rng.integers(0, pack, m)) % pack).astype(np.int32)
    ids = seg.astype(np.int64) * pack + lo
    _check_segsum(ids, _grid_normal(rng, (m, e)), pack)
    g = rng.normal(size=(m, e)).astype(np.float32)
    args = (torch.from_numpy(lo), torch.from_numpy(seg), pack)
    got = K.widen_segment_sum(torch.from_numpy(g), *args).numpy()
    assert np.array_equal(got, K.widen_segment_sum(torch.from_numpy(g), *args).numpy())
    ref = np.asarray(jax_segsum(jnp.asarray(g), jnp.asarray(lo), jnp.asarray(seg), pack,
                                interpret=True))
    ref64, abs64 = _widen64(g, lo, seg, pack), _widen64(np.abs(g), lo, seg, pack)
    assert_within_float64_bound(got, ref64, abs64, seg)
    assert_within_float64_bound(ref, ref64, abs64, seg)


def _update_case(rule, wd, seed):
    rng = np.random.default_rng(seed)
    rows, w, m = 40, 128, 900
    table = rng.normal(size=(rows, w)).astype(np.float32)
    ids = rng.integers(0, rows, size=30)
    uniq = np.unique(ids).astype(np.int32)
    n_valid = uniq.shape[0]
    uids = np.full(m, rows, np.int32)
    uids[:n_valid] = uniq
    gsum = np.zeros((m, w), np.float32)
    gsum[:n_valid] = rng.normal(size=(n_valid, w))
    t = 4.0
    if rule == "adam":
        slots = [np.stack([rng.normal(0, 0.1, (rows, w)),
                           rng.uniform(0, 0.1, (rows, w))], axis=1).astype(np.float32)]
        hyper = [0.05, 0.9, 0.999, 1e-8, wd, 1 / (1 - 0.9 ** t), 1 / (1 - 0.999 ** t)]
    elif rule == "adagrad":
        slots = [rng.uniform(0.1, 1.0, (rows, w)).astype(np.float32)]
        hyper = [0.05, 0, 0, 1e-7, 0, 1, 1]
    else:
        slots = []
        hyper = [0.05, 0, 0, 0, 0, 1, 1]
    return uids, gsum, table, slots, np.asarray(hyper, np.float32), n_valid


@pytest.mark.parametrize("rule,wd", [("adam", 0.0), ("adam", 1e-3), ("adagrad", 0.0),
                                     ("sgd", 0.0)])
def test_fused_rowwise_update_matches_pallas(rule, wd):
    uids, gsum, table, slots, hyper, n_valid = _update_case(rule, wd, seed=7)
    ref_t, ref_s = jax_update(
        jnp.asarray(uids), jnp.asarray(gsum), jnp.asarray(table),
        tuple(jnp.asarray(s) for s in slots), jnp.asarray(hyper), rule,
        interpret=True, n_valid=jnp.asarray([n_valid], jnp.int32),
    )
    t_table = torch.from_numpy(table.copy())
    t_slots = [torch.from_numpy(s.copy()) for s in slots]
    got_t, got_s = K.fused_rowwise_update(
        torch.from_numpy(uids), torch.from_numpy(gsum), t_table, t_slots,
        torch.from_numpy(hyper), rule, n_valid,
    )
    assert got_t is t_table  # updated in place
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), rtol=0, atol=ATOL)
    for got, ref in zip(got_s, ref_s):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    untouched = np.setdiff1d(np.arange(table.shape[0]), uids[:n_valid])
    np.testing.assert_array_equal(got_t.numpy()[untouched], table[untouched])
    for got, orig in zip(got_s, slots):
        np.testing.assert_array_equal(got.numpy()[untouched], orig[untouched])


def test_fused_rowwise_update_rejects_bad_inputs():
    uids, gsum, table, slots, hyper, n_valid = _update_case("adam", 0.0, seed=1)
    args = [torch.from_numpy(a) for a in (uids, gsum, table)]
    with pytest.raises(ValueError, match="rule"):
        K.fused_rowwise_update(*args, [torch.from_numpy(slots[0])],
                               torch.from_numpy(hyper), "lamb", n_valid)
    with pytest.raises(ValueError, match="slot"):
        K.fused_rowwise_update(*args, [], torch.from_numpy(hyper), "adam", n_valid)
    with pytest.raises(ValueError, match="n_valid"):
        K.fused_rowwise_update(*args, [torch.from_numpy(slots[0])],
                               torch.from_numpy(hyper), "adam", uids.shape[0] + 1)


def test_widen_segment_sum_rejects_bad_inputs():
    g = torch.zeros(8, 16)
    lo = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        K.widen_segment_sum(g, lo, torch.zeros(8, dtype=torch.int64), 8)
    with pytest.raises(ValueError, match="float32"):
        K.widen_segment_sum(g.double(), lo, lo, 8)


def test_kernels_are_not_built_or_counted_on_the_cpu():
    before = (K.widen_segment_sum.launches, K.fused_rowwise_update.launches)
    _check_segsum(np.arange(64, dtype=np.int32), np.ones((64, 16), np.float32), 8)
    assert (K.widen_segment_sum.launches, K.fused_rowwise_update.launches) == before
