"""Embedding lookup primitives over the packed stored table layout.

Counterpart of ``torecsys_tpu/ops/embedding.py``.  A logical ``(V, E)`` table
is stored packed as ``(ceil(V/P), P*E)``: ``P`` logical rows side by side in
one stored row.  The port keeps this layout, so the sparse update kernels'
contract (stored-row ids, summed gradients of width ``P*E``) and the weight
carry-over from the JAX package stay a reshape.
"""

from __future__ import annotations

import math
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


def table_grad(ids: torch.Tensor, grad: torch.Tensor, table_shape,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The packed table's gradient of a lookup: each row of the ``(M, E)``
    cotangent ``grad`` added into logical row ``ids[i]`` of a zero
    ``(Vp, P*E)`` table of ``dtype`` (of ``table_shape``: a field-aware
    ``(N, Vp, P*E)`` table's gradient is summed over its ``(N*Vp, P*E)``
    rows), with one writer per row and no atomics.

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

    A bf16 table (the dense route's, ``layers.precision``) gets a bf16
    cotangent: it is summed in float32 all the same and the sum rounded once
    to ``dtype``, where the JAX package's ``.at[].add`` adds in bf16.  A row
    touched once gets the same bits either way; one touched L times differs
    from the bf16 sum by its L - 1 intermediate roundings, up to about
    ``(L - 1) * 2**-8`` of the sum's magnitude.
    """
    w = table_shape[-1]
    vp = math.prod(table_shape[:-1])
    e = grad.shape[1]
    pack = w // e
    rows = vp * pack
    if rows >= 2**31:
        raise ValueError(f"a table of {rows} logical rows is too large for int32 ids")
    row, valid = _kernels.wrap_ids(ids, rows)
    keys = torch.where(valid, row, torch.full_like(row, rows)).to(torch.int32)
    sorted_ids, order = torch.sort(keys, stable=True)
    g_sorted = _kernels.row_gather(grad.float().contiguous(), order)
    d_table = g_sorted.new_zeros(vp, w)
    hyper = g_sorted.new_zeros(7)
    hyper[:1].fill_(-1.0)  # lr, sgd reads nothing else; a fill, not a copy from the host
    _sparse_kernels.fused_sorted_dedup_update(sorted_ids, g_sorted, d_table, (), hyper,
                                              pack, "sgd")
    return d_table.reshape(table_shape).to(dtype)


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
        ctx.table_dtype = packed_table.dtype
        return _kernels.row_gather(packed_table.reshape(-1, embed_size), ids)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (ids,) = ctx.saved_tensors
        return table_grad(ids, grad, ctx.table_shape, ctx.table_dtype), None, None


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


def bag_starts(hots: Sequence[int]) -> np.ndarray:
    """The ``(N + 1,)`` int32 slot offsets of ``N`` bags of ``hots`` slots
    each: bag ``n`` holds slots ``[starts[n], starts[n + 1])``."""
    return np.concatenate([[0], np.cumsum(hots)]).astype(np.int32)


def slot_bags(hots: Sequence[int]) -> np.ndarray:
    """The ``(S,)`` int64 bag of each slot of bags of ``hots`` slots."""
    return np.repeat(np.arange(len(hots)), hots).astype(np.int64)


def pooled_grad(ids: torch.Tensor, grad: torch.Tensor, bags: torch.Tensor, table_shape,
                dtype: torch.dtype, lo: int, hi: int, base: int) -> torch.Tensor:
    """The packed table's gradient of a pooled lookup: each slot's row takes
    its bag's cotangent ``grad[:, bags[s]]``, summed per row by
    :func:`table_grad`; a slot whose id lies outside ``[lo, hi)`` adds
    nothing."""
    e = grad.shape[-1]
    rows = math.prod(table_shape[:-1]) * (table_shape[-1] // e)
    idx = ids.to(torch.int64)
    keys = torch.where((idx >= lo) & (idx < hi), idx - base, torch.full_like(idx, rows))
    slots = grad.index_select(1, bags).reshape(-1, e)
    return table_grad(keys.reshape(-1), slots, table_shape, dtype)


class _PooledGather(torch.autograd.Function):
    """:func:`pooled_lookup` through the ``pooled_row_gather`` kernel; the
    backward is :func:`pooled_grad`."""

    @staticmethod
    def forward(ctx, packed_table, ids, starts, bags, embed_size, lo, hi, base):
        ctx.save_for_backward(ids, bags)
        ctx.meta = (packed_table.shape, packed_table.dtype, lo, hi, base)
        return _kernels.pooled_row_gather(packed_table.reshape(-1, embed_size), ids, starts,
                                          lo, hi, base)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        ids, bags = ctx.saved_tensors
        shape, dtype, lo, hi, base = ctx.meta
        return (pooled_grad(ids, grad, bags, shape, dtype, lo, hi, base),
                None, None, None, None, None, None, None)


def pooled_lookup(packed_table: torch.Tensor, ids: torch.Tensor, starts: torch.Tensor,
                  bags: torch.Tensor, embed_size: int, lo: int = 0, hi: Optional[int] = None,
                  base: int = 0) -> torch.Tensor:
    """Bag sums of a multi-hot lookup from a packed float32 table: ``(B, S)``
    logical ids, bag ``n`` the slots ``[starts[n], starts[n + 1])`` (``bags``:
    each slot's bag) → ``(B, N, E)``, each bag the sum of its ids' rows.
    Only the logical rows ``[lo, hi)`` are read (default: all of the
    table's), the table's first row being logical row ``base``; an id
    outside them adds nothing.  One ``pooled_row_gather`` kernel;
    differentiable in the table (:func:`pooled_grad`)."""
    if hi is None:
        hi = base + packed_table.numel() // embed_size
    return _PooledGather.apply(packed_table, ids, starts, bags, embed_size, lo, hi, base)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain table gather ``table[ids]``, as ``jnp.take(table, ids, axis=0)``:
    ``table`` ``(V, E)`` float32 or bfloat16, ``ids`` any integer shape, the
    result ``(..., E)``.  It is the ``row_gather`` kernel on the card and its
    plain twin on the CPU, with :func:`table_grad` as the backward.  Ids
    follow ``jnp.take``'s default mode: an id in ``[-V, 0)`` reads row
    ``V + id``, the row of an id outside ``[-V, V)`` is NaN, and its
    gradient is dropped."""
    out = _RowGather.apply(table, ids.reshape(-1), table.shape[-1])
    return out.reshape(*ids.shape, table.shape[-1])


def fused_offset_lookup(table: torch.Tensor, ids: torch.Tensor,
                        offsets: Optional[np.ndarray] = None) -> torch.Tensor:
    """Gather with per-field offsets applied: ``table[ids + offsets]``.

    Args:
        table: ``(V, E)`` fused table (V = sum of field vocab sizes).
        ids: ``(B, N)`` raw per-field ids.
        offsets: ``(N,)`` int offsets (:func:`field_offsets`), added in
            ``ids``' dtype; None = zeros.

    Returns:
        ``(B, N, E)``, ids out of range as :func:`embedding_lookup` takes them.
    """
    if offsets is not None:
        ids = ids + torch.as_tensor(np.asarray(offsets), device=ids.device).to(ids.dtype)[None, :]
    return embedding_lookup(table, ids)


__all__ = ["bag_starts", "embedding_lookup", "field_offsets", "fused_offset_lookup",
           "pack_factor", "pack_table", "packed_lookup", "packed_shape", "pooled_grad",
           "pooled_lookup", "slot_bags", "table_grad", "unpack_table"]
