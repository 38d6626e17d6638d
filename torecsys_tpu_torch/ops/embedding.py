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


class _RowGather(torch.autograd.Function):
    """``packed_table.reshape(-1, E)[ids]`` through the ``row_gather`` kernel.

    Counterpart of ``_row_gather_cvjp`` (``ops/pallas/embedding.py``): the
    forward is the kernel; the backward scatter-adds the cotangent into a
    zero table-shaped gradient, one ``index_add_`` on the logical
    ``(Vp*P, E)`` view, as the JAX backward is XLA's ``.at[rows].add`` and
    no kernel.  On the card ``index_add_`` sums duplicate ids with atomics,
    in an order that changes from run to run, so the table gradient is not
    bit-reproducible there.  Ids wrap as in the forward
    (:func:`~torecsys_tpu_torch.ops.kernels.embedding.wrap_ids`): a negative
    id in ``[-rows, 0)`` adds into row ``rows + id``, and an id outside
    ``[-rows, rows)`` adds nothing, as ``.at[].add`` drops it (its forward
    row is NaN).
    """

    @staticmethod
    def forward(ctx, packed_table: torch.Tensor, ids: torch.Tensor, embed_size: int):
        ctx.save_for_backward(ids)
        ctx.table_shape = packed_table.shape
        return _kernels.row_gather(packed_table.reshape(-1, embed_size), ids)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (ids,) = ctx.saved_tensors
        rows = ctx.table_shape.numel() // grad.shape[1]
        # index_add_ asserts on the card for an index outside the table.
        row, valid = _kernels.wrap_ids(ids, rows)
        grad = grad.masked_fill(~valid[:, None], 0.0)
        d_table = grad.new_zeros(rows, grad.shape[1]).index_add_(0, row, grad)
        return d_table.reshape(ctx.table_shape), None, None


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
           "packed_shape", "unpack_table"]
