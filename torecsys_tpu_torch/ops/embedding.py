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


def packed_lookup(packed_table: torch.Tensor, ids: torch.Tensor,
                  embed_size: int) -> torch.Tensor:
    """Gather from a packed table: ``logical_table[ids]``, shape ``(..., E)``.

    The stored-row gather ``ids // P`` and the in-row slot select ``ids % P``
    collapse into one ``index_select`` on the ``(Vp*P, E)`` view of the
    contiguous packed table, which is the logical table; it reads E floats
    per id instead of a whole stored row.
    """
    rows = packed_table.reshape(-1, embed_size)
    out = rows.index_select(0, ids.reshape(-1))
    return out.reshape(*ids.shape, embed_size)


__all__ = ["field_offsets", "pack_factor", "pack_table", "packed_lookup",
           "packed_shape", "unpack_table"]
