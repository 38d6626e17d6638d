"""The lookup's deterministic backward on the CPU (plain versions), against
the JAX package and the port's earlier ``index_add_`` form.

* ``table_grad`` (``_RowGather``'s backward: a stable sort of the wrapped
  ids, the ``row_gather`` permute, then ``fused_sorted_dedup_update`` with
  sgd at ``lr = -1`` into a zero table) against ``jax.grad`` through the
  Pallas ``row_gather`` in interpret mode, with duplicate, negative and
  past-the-table ids: atol 1e-6 (random cotangents, sums in another order).
* ``table_grad`` bit-equal to a wrapped ``index_add_`` on 2^-10-grid
  cotangents, where every partial sum is exact in float32.

The grad permutes of ``sort_slot_grads`` and ``update_from_host_aux`` are
held against the JAX package in ``test_torch_dedup.py`` and
``test_torch_sparse.py``; the row gather's sweep streams against the Pallas
gather in ``test_torch_lookup.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torecsys_tpu.ops.pallas import embedding as pe
from torecsys_tpu_torch.ops import embedding
from torecsys_tpu_torch.ops.kernels import embedding as KE


def _grid_normal(rng, shape):
    return (np.round(rng.normal(size=shape) * 1024) / 1024).astype(np.float32)


def _mixed_ids(rng, rows, m):
    """Logical ids of a table of ``rows`` rows: Zipf duplicates, every
    negative id in ``[-rows, 0)`` once, and ids past either end."""
    zipf = np.minimum(rng.zipf(1.3, m) - 1, rows - 1)
    past = np.array([rows, rows + 5, -rows - 1, -rows - 9, 10**6])
    ids = np.concatenate([zipf, np.arange(-rows, 0), past])
    return rng.permutation(ids).astype(np.int64)


def _index_add_grad(ids, cot, table_shape):
    """The lookup's former backward: ``index_add_`` of the wrapped ids into
    the logical view, ids outside ``[-rows, rows)`` dropped."""
    vp, w = table_shape
    e = cot.shape[1]
    rows = vp * (w // e)
    row, valid = KE.wrap_ids(ids, rows)
    cot = cot.masked_fill(~valid[:, None], 0.0)
    return cot.new_zeros(rows, e).index_add_(0, row, cot).reshape(vp, w)


@pytest.mark.parametrize("pack", [1, 2, 8])
def test_table_grad_matches_jax_grad_through_pallas_gather(pack, monkeypatch):
    """The backward through ``packed_lookup`` against ``jax.grad`` of the same
    loss through the Pallas ``row_gather`` (its stored-row gather, the slot
    selected by a one-hot, as ``test_row_gather_backward_matches_jax_grad``
    does): negative ids wrap into row ``rows + id``, ids outside ``[-rows,
    rows)`` add nothing (the JAX backward's ``.at[].add`` drops them)."""
    monkeypatch.setattr(pe, "_row_gather_impl",
                        functools.partial(pe._row_gather_impl, interpret=True))
    rng = np.random.default_rng(40 + pack)
    e = 128 // pack
    vp = 6
    rows = vp * pack
    table = rng.normal(size=(vp, pack * e)).astype(np.float32)
    ids = _mixed_ids(rng, rows, 60)
    cot = rng.normal(size=(ids.shape[0], e)).astype(np.float32)
    oh = jax.nn.one_hot(ids % pack, pack, dtype=jnp.float32)

    def jax_loss(t):
        # floor division wraps a negative logical id into its stored row and
        # slot; the stored rows of ids past the table fall outside [-Vp, Vp)
        stored = jnp.asarray(ids // pack, jnp.int32)
        wide = pe.row_gather(t, stored).reshape(-1, pack, e)
        return jnp.sum(cot * jnp.einsum("mp,mpe->me", oh, wide))

    ref = np.asarray(jax.grad(jax_loss)(jnp.asarray(table)))
    t = torch.from_numpy(table.copy()).requires_grad_(True)
    out = embedding.packed_lookup(t, torch.from_numpy(ids), e)
    out = torch.nan_to_num(out)  # the NaN rows of ids past the table
    (out * torch.from_numpy(cot)).sum().backward()
    assert t.grad.shape == (vp, pack * e)
    np.testing.assert_allclose(t.grad.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("pack,m", [(1, 700), (8, 700), (8, 1), (8, 0)])
def test_table_grad_equals_index_add_on_grid_cotangents(pack, m):
    rng = np.random.default_rng(50 + pack + m)
    e, vp = 128 // pack, 40
    ids = torch.from_numpy(_mixed_ids(rng, vp * pack, m) if m > 1 else np.full(m, -3))
    cot = torch.from_numpy(_grid_normal(rng, (ids.shape[0], e)))
    got = embedding.table_grad(ids, cot, (vp, pack * e))
    assert got.shape == (vp, pack * e)
    assert torch.equal(got, _index_add_grad(ids, cot, (vp, pack * e)))
    int32 = embedding.table_grad(ids.to(torch.int32), cot, (vp, pack * e))
    assert torch.equal(int32, got)


def test_table_grad_refuses_tables_past_int32_ids():
    ids = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="int32"):
        embedding.table_grad(ids, torch.zeros(3, 16), (2**28, 128))  # 2^31 logical rows


def test_packed_lookup_backward_is_table_grad():
    rng = np.random.default_rng(60)
    table = torch.from_numpy(rng.normal(size=(5, 128)).astype(np.float32)).requires_grad_(True)
    ids = torch.from_numpy(_mixed_ids(rng, 40, 50))
    cot = torch.from_numpy(rng.normal(size=(ids.shape[0], 16)).astype(np.float32))
    embedding.packed_lookup(table, ids, 16).backward(cot)
    assert torch.equal(table.grad, embedding.table_grad(ids, cot, (5, 128)))
