"""The port's lookup kernels (plain versions, on the CPU) against the JAX
package: ``row_gather`` against the Pallas gather in interpret mode and
against ``packed_lookup``, its autograd backward against ``jax.grad``, and
``segment_sum_wide`` against ``sorted_segment_sum_wide`` in interpret mode;
negative ids wrap as ``jnp.take`` wraps them, forward and backward.

A gather is a copy, so the lookups must agree to the bit.  Segment sums
are drawn on a 2^-10 grid, where every partial sum is exact in float32, so
they too must agree to the bit whatever the order of summation.  The
gradient is a scatter-add of random cotangents: atol 1e-6.  The segment
sums' sweep streams (``test_torch_kernels.py``) also check real-valued rows
against the float64 rounding bound.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torecsys_tpu.ops import embedding as jax_embedding
from torecsys_tpu.ops.pallas import embedding as pe
from torecsys_tpu.ops.pallas.sparse_update import TILE_P
from torecsys_tpu.ops.pallas.sparse_update import sorted_segment_sum_wide as jax_segsum_wide
from torecsys_tpu_torch.ops import embedding
from torecsys_tpu_torch.ops.kernels import embedding as KE
from torecsys_tpu_torch.ops.kernels import sparse_update as K

from test_torch_kernels import SWEEP_STREAMS, assert_within_float64_bound, sweep_segments


def _grid_normal(rng, shape):
    return (np.round(rng.normal(size=shape) * 1024) / 1024).astype(np.float32)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_row_gather_matches_pallas_gather_on_stored_rows(dtype):
    rng = np.random.default_rng(0)
    m, w = 300, 128
    table = rng.normal(size=(m, w)).astype(np.float32)
    rows = rng.integers(0, m, size=pe.TILE + 70).astype(dtype)  # not a multiple of TILE
    ref = pe._row_gather_impl(jnp.asarray(table), jnp.asarray(rows.astype(np.int32)),
                              interpret=True)
    got = KE.row_gather(torch.from_numpy(table), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("pack", [1, 2, 4, 8])
def test_packed_lookup_matches_jax_on_the_logical_view(pack):
    rng = np.random.default_rng(pack)
    v, e = 1001, 128 // pack
    logical = rng.normal(size=(v, e)).astype(np.float32)
    packed = jax_embedding.pack_table(jnp.asarray(logical), pack)
    ids = rng.integers(0, v, (37, 5))
    ref = jax_embedding.packed_lookup(packed, jnp.asarray(ids), e)
    got = embedding.packed_lookup(torch.from_numpy(np.array(packed)), torch.from_numpy(ids), e)
    assert got.shape == (37, 5, e)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    got32 = KE.row_gather(torch.from_numpy(np.array(packed)).reshape(-1, e),
                          torch.from_numpy(ids.reshape(-1).astype(np.int32)))
    np.testing.assert_array_equal(got32.numpy(), np.asarray(ref).reshape(-1, e))


@pytest.mark.parametrize("pack", [1, 8])
def test_ids_past_the_table_give_nan_as_the_jax_lookup(pack):
    rng = np.random.default_rng(5)
    v, e = 21, 128 // pack
    packed = jax_embedding.pack_table(jnp.asarray(rng.normal(size=(v, e)).astype(np.float32)),
                                      pack)
    stored_rows = packed.shape[0] * pack
    ids = np.array([0, v - 1, stored_rows - 1, stored_rows, stored_rows + 7, 10**6])
    ref = np.asarray(jax_embedding.packed_lookup(packed, jnp.asarray(ids), e))
    got = embedding.packed_lookup(torch.from_numpy(np.array(packed)), torch.from_numpy(ids), e)
    assert np.isnan(ref[3:]).all() and not np.isnan(ref[:3]).any()
    np.testing.assert_array_equal(got.numpy(), ref)  # NaN == NaN here


@pytest.mark.parametrize("pack", [1, 8])
def test_negative_ids_wrap_as_the_jax_lookup(pack):
    """``jnp.take``'s rule, forward and table gradient: an id in
    ``[-rows, 0)`` reads and scatters into row ``rows + id`` of the logical
    view, an id outside ``[-rows, rows)`` gives NaN and adds nothing."""
    rng = np.random.default_rng(12)
    v, e = 20, 128 // pack
    packed = jax_embedding.pack_table(jnp.asarray(rng.normal(size=(v, e)).astype(np.float32)),
                                      pack)
    rows = packed.shape[0] * pack  # the logical view: 24 rows at pack 8
    ids = np.arange(-rows - 2, rows + 2)
    cot = rng.normal(size=(ids.shape[0], e)).astype(np.float32)

    ref = np.asarray(jax_embedding.packed_lookup(packed, jnp.asarray(ids), e))
    ref_grad = np.asarray(jax.grad(
        lambda t: jnp.sum(cot * jax_embedding.packed_lookup(t, jnp.asarray(ids), e)))(packed))
    assert np.isnan(ref[[0, 1, -2, -1]]).all() and not np.isnan(ref[2:-2]).any()

    t = torch.from_numpy(np.array(packed)).requires_grad_(True)
    got = embedding.packed_lookup(t, torch.from_numpy(ids), e)
    np.testing.assert_array_equal(got.detach().numpy(), ref)  # NaN == NaN here
    got32 = KE.row_gather(t.detach().reshape(-1, e), torch.from_numpy(ids.astype(np.int32)))
    np.testing.assert_array_equal(got32.numpy(), ref)
    (got * torch.from_numpy(cot)).sum().backward()
    assert np.isfinite(ref_grad).all()
    np.testing.assert_allclose(t.grad.numpy(), ref_grad, rtol=0, atol=1e-6)


def test_row_gather_backward_matches_jax_grad(monkeypatch):
    """``_RowGather``'s scatter-add against ``jax.grad`` through the Pallas
    ``row_gather`` (interpret-mode impl), duplicate ids included."""
    monkeypatch.setattr(pe, "_row_gather_impl",
                        functools.partial(pe._row_gather_impl, interpret=True))
    rng = np.random.default_rng(1)
    m, w, e = 16, 128, 16
    table = rng.normal(size=(m, w)).astype(np.float32)
    ids = np.array([0, 3, 3, 127, 0, 0, 64, 9, 9, 9], dtype=np.int64)  # logical ids
    cot = rng.normal(size=(ids.shape[0], e)).astype(np.float32)

    # The JAX side gathers stored rows and selects the slot, as packed_lookup
    # does, with the kernel's custom VJP on the stored-row gather.
    pack = w // e
    oh = jax.nn.one_hot(ids % pack, pack, dtype=jnp.float32)

    def jax_loss(t):
        wide = pe.row_gather(t, jnp.asarray(ids // pack, jnp.int32)).reshape(-1, pack, e)
        return jnp.sum(cot * jnp.einsum("mp,mpe->me", oh, wide))

    ref = np.asarray(jax.grad(jax_loss)(jnp.asarray(table)))
    t = torch.from_numpy(table.copy()).requires_grad_(True)
    out = embedding.packed_lookup(t, torch.from_numpy(ids), e)
    (out * torch.from_numpy(cot)).sum().backward()
    assert t.grad.shape == (m, w)
    np.testing.assert_allclose(t.grad.numpy(), ref, rtol=0, atol=1e-6)


def test_row_gather_backward_drops_ids_past_the_table():
    t = torch.zeros(2, 32, requires_grad=True)
    out = embedding.packed_lookup(t, torch.tensor([1, 8, 99]), 16)
    assert torch.isnan(out[2]).all()
    out[:2].sum().backward()
    want = torch.zeros(4, 16)
    want[1] = 1.0
    torch.testing.assert_close(t.grad.reshape(4, 16), want, rtol=0, atol=0)


def test_sparse_route_lookup_is_a_leaf_without_a_graph():
    table = torch.randn(4, 128, requires_grad=True)
    rows = embedding.packed_lookup(table.detach(), torch.tensor([[0, 9]]), 16)
    assert rows.grad_fn is None and rows.is_leaf
    with torch.no_grad():
        assert embedding.packed_lookup(table, torch.tensor([[0, 9]]), 16).grad_fn is None


def _check_segsum_wide(seg, w=128, seed=3):
    rng = np.random.default_rng(seed)
    seg = np.asarray(seg, np.int32)
    wide = _grid_normal(rng, (seg.shape[0], w))
    ref = np.asarray(jax_segsum_wide(jnp.asarray(wide), jnp.asarray(seg), interpret=True))
    got = K.segment_sum_wide(torch.from_numpy(wide), torch.from_numpy(seg))
    n_seg = int(seg[-1]) + 1
    assert got.shape == wide.shape
    # The JAX output past the last segment is unspecified; the port's is zero.
    np.testing.assert_array_equal(got.numpy()[:n_seg], ref[:n_seg])
    assert not got[n_seg:].any()


def test_segment_sum_wide_random_segments_cross_tiles():
    rng = np.random.default_rng(0)
    lens = rng.integers(1, 40, 120)
    lens[60] = TILE_P + 200  # one segment longer than a tile, across a boundary
    _check_segsum_wide(np.repeat(np.arange(len(lens)), lens)[:3 * TILE_P - 100])


def test_segment_sum_wide_single_segment():
    _check_segsum_wide(np.zeros(TILE_P + 300, np.int32), seed=4)


@pytest.mark.parametrize("stream", SWEEP_STREAMS)
def test_segment_sum_wide_sweep_streams(stream):
    rng = np.random.default_rng(30)
    seg = sweep_segments(stream, rng)
    _check_segsum_wide(seg, seed=31)
    wide = rng.normal(size=(seg.shape[0], 128)).astype(np.float32)
    got = K.segment_sum_wide(torch.from_numpy(wide), torch.from_numpy(seg)).numpy()
    assert np.array_equal(got, K.segment_sum_wide(torch.from_numpy(wide),
                                                  torch.from_numpy(seg)).numpy())
    n_seg = int(seg[-1]) + 1
    ref = np.asarray(jax_segsum_wide(jnp.asarray(wide), jnp.asarray(seg), interpret=True))
    ref64, abs64 = np.zeros(wide.shape), np.zeros(wide.shape)
    np.add.at(ref64, seg, wide.astype(np.float64))
    np.add.at(abs64, seg, np.abs(wide.astype(np.float64)))
    assert_within_float64_bound(got, ref64, abs64, seg)
    assert_within_float64_bound(ref[:n_seg], ref64[:n_seg], abs64[:n_seg], seg)


def test_lookup_kernels_reject_bad_inputs():
    with pytest.raises(ValueError, match="int32 or int64"):
        KE.row_gather(torch.zeros(4, 16), torch.zeros(3, dtype=torch.float32))
    with pytest.raises(ValueError, match="float32"):
        KE.row_gather(torch.zeros(4, 16, dtype=torch.float64), torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="int32"):
        K.segment_sum_wide(torch.zeros(8, 128), torch.zeros(8, dtype=torch.int64))
    with pytest.raises(ValueError, match="float32"):
        K.segment_sum_wide(torch.zeros(8, 128, dtype=torch.float64),
                           torch.zeros(8, dtype=torch.int32))


def test_lookup_kernels_are_not_built_or_counted_on_the_cpu():
    before = (KE.row_gather.launches, K.segment_sum_wide.launches)
    embedding.packed_lookup(torch.zeros(4, 128), torch.tensor([1, 2]), 16)
    K.segment_sum_wide(torch.ones(4, 128), torch.zeros(4, dtype=torch.int32))
    assert (KE.row_gather.launches, K.segment_sum_wide.launches) == before
