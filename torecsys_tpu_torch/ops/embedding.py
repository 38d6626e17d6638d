"""Embedding lookup primitives over the packed stored table layout.

Counterpart of ``torecsys_tpu/ops/embedding.py``.  A logical ``(V, E)`` table
is stored packed as ``(ceil(V/P), P*E)``: ``P`` logical rows side by side in
one stored row.  The port keeps this layout, so the sparse update kernels'
contract (stored-row ids, summed gradients of width ``P*E``) and the weight
carry-over from the JAX package stay a reshape.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from torecsys_tpu_torch.ops.kernels import embedding as _kernels
from torecsys_tpu_torch.ops.kernels import sparse_update as _sparse_kernels


def field_offsets(field_sizes: Sequence[int]) -> np.ndarray:
    """Exclusive cumulative sum of field vocab sizes: field ``i``'s raw ids
    are shifted by ``sum(field_sizes[:i])`` into the fused table."""
    return np.concatenate([[0], np.cumsum(field_sizes)[:-1]]).astype(np.int32)


def pack_factor(embed_size: int, target_lanes: int = 128) -> int:
    """Logical rows per stored row: the largest power of two ``P`` with
    ``P * embed_size <= target_lanes`` (at least 1)."""
    p = max(1, target_lanes // max(1, embed_size))
    while p & (p - 1):  # round down to a power of two
        p &= p - 1
    return p


def packed_shape(total_rows: int, embed_size: int, pack: Optional[int] = None):
    """Stored shape ``(ceil(V/P), P*E)`` for a logical ``(V, E)`` table."""
    p = pack_factor(embed_size) if pack is None else pack
    return (-(-total_rows // p), p * embed_size)


def pack_table(table: torch.Tensor, pack: Optional[int] = None) -> torch.Tensor:
    """Re-layout a logical ``(V, E)`` table into packed ``(ceil(V/P), P*E)``."""
    v, e = table.shape
    p = pack_factor(e) if pack is None else pack
    pad = (-v) % p
    if pad:
        table = torch.cat([table, table.new_zeros(pad, e)])
    return table.reshape(-1, p * e)


def unpack_table(packed: torch.Tensor, embed_size: int, total_rows: int) -> torch.Tensor:
    """Inverse of :func:`pack_table` (drops padding rows)."""
    return packed.reshape(-1, embed_size)[:total_rows]


def table_grad(ids: torch.Tensor, grad: torch.Tensor, table_shape) -> torch.Tensor:
    """The packed table's gradient of a lookup: each row of the ``(M, E)``
    cotangent ``grad`` added into logical row ``ids[i]`` of a zero
    ``(Vp, P*E)`` table, with one writer per row and no atomics.

    Ids wrap as in the forward
    (:func:`~torecsys_tpu_torch.ops.kernels.embedding.wrap_ids`): an id in
    ``[-rows, 0)`` adds into row ``rows + id`` and an id outside ``[-rows,
    rows)`` adds nothing, as ``.at[].add`` drops it (its forward row is NaN).
    The ids are mapped to int32 logical rows, an id outside the table to the
    sentinel ``rows`` = Vp*P, and sorted stably (the on-device route's sort);
    ``row_gather`` permutes the cotangent into that order; and
    ``fused_sorted_dedup_update`` with rule ``sgd`` and ``lr = -1`` sums each
    stored row's group into the zero table (``0 - (-1) * g`` is ``g``, as
    long as the sgd rule reads no hyper but ``lr``), on the card in its
    position tiles, the same bits from run to run.  The
    sentinel's stored row Vp lies past the table and is summed but never
    written.  On the CPU the plain versions sum each row in position order,
    as ``index_add_`` does.
    """
    vp, w = table_shape
    e = grad.shape[1]
    pack = w // e
    rows = vp * pack
    if rows >= 2**31:
        raise ValueError(f"a table of {rows} logical rows is too large for int32 ids")
    row, valid = _kernels.wrap_ids(ids, rows)
    keys = torch.where(valid, row, torch.full_like(row, rows)).to(torch.int32)
    sorted_ids, order = torch.sort(keys, stable=True)
    g_sorted = _kernels.row_gather(grad.contiguous(), order)
    d_table = grad.new_zeros(vp, w)
    hyper = grad.new_zeros(7)
    hyper[:1].fill_(-1.0)  # lr, sgd reads nothing else; a fill, not a copy from the host
    _sparse_kernels.fused_sorted_dedup_update(sorted_ids, g_sorted, d_table, (), hyper,
                                              pack, "sgd")
    return d_table


class _RowGather(torch.autograd.Function):
    """``packed_table.reshape(-1, E)[ids]`` through the ``row_gather`` kernel.

    Counterpart of ``_row_gather_cvjp`` (``ops/pallas/embedding.py``): the
    forward is the kernel; the backward (:func:`table_grad`) sums the
    cotangent per table row, as the JAX backward is XLA's ``.at[rows].add``,
    but sorted and tiled instead of scattered with atomics, so the table
    gradient is the same bits from run to run on the card.
    """

    @staticmethod
    def forward(ctx, packed_table: torch.Tensor, ids: torch.Tensor, embed_size: int):
        ctx.save_for_backward(ids)
        ctx.table_shape = packed_table.shape
        return _kernels.row_gather(packed_table.reshape(-1, embed_size), ids)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (ids,) = ctx.saved_tensors
        return table_grad(ids, grad, ctx.table_shape), None, None


def packed_lookup(packed_table: torch.Tensor, ids: torch.Tensor,
                  embed_size: int) -> torch.Tensor:
    """Gather from a packed table: ``logical_table[ids]``, shape ``(..., E)``.

    The stored-row gather ``ids // P`` and the in-row slot select ``ids % P``
    collapse into one ``row_gather`` on the ``(Vp*P, E)`` view of the
    contiguous packed table, which is the logical table; it reads E floats
    per id instead of a whole stored row.  Differentiable in the table
    (:class:`_RowGather`).
    """
    out = _RowGather.apply(packed_table, ids.reshape(-1), embed_size)
    return out.reshape(*ids.shape, embed_size)


__all__ = ["field_offsets", "pack_factor", "pack_table", "packed_lookup",
           "packed_shape", "table_grad", "unpack_table"]
