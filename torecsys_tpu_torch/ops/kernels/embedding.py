"""Embedding lookup kernels: the row gather, the pooled row gather and the
unique stored-row gather.

Counterpart of ``torecsys_tpu/ops/pallas/embedding.py``.  Three kernels,
written in CUDA C++ for Hopper in ``csrc/embedding.cu`` (its header says
what bounds each on the card and how the design answers it):

* :func:`row_gather` replaces its ``row_gather`` (``_gather_kernel``).  It
  also permutes the sparse routes' grads into id order (``ops/sparse.py``)
  and the lookup's cotangent in its backward (``ops/embedding.py``), which
  sums it per row with ``fused_sorted_dedup_update``;
* :func:`pooled_row_gather`, which replaces no Pallas kernel, sums each
  bag of a multi-hot lookup (``inputs.embeddings.MultiHotIndicesEmbedding``)
  in the same pass as it gathers the rows, on one card or over a rank's
  rows of a row-sharded table;
* :func:`unique_stored_gather` replaces ``unique_stored_gather``
  (``_unique_gather_kernel``), an op that no path of either package calls.

Each wrapper takes the plain PyTorch version (``*_plain``) for tensors on
the CPU, launches its kernel for tensors on the card, and raises on anything
else: a mix of devices, a wrong dtype, shape or layout.  ``launches`` on each
wrapper counts its kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from torecsys_tpu_torch.ops import kernels as _k

SOURCE = "embedding.cu"
INDEX_DTYPES = (torch.int32, torch.int64)
ROW_DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    lib = _k.load_library(SOURCE)
    if not getattr(lib, "_trs_typed", False):
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.trs_row_gather.argtypes = [p, p, i, p, i64, i64, i, i, p]
        lib.trs_row_gather.restype = i
        lib.trs_unique_stored_gather.argtypes = [p, p, p, i64, i64, i, i, p]
        lib.trs_unique_stored_gather.restype = i
        lib.trs_pooled_row_gather.argtypes = [p, p, i, p, p, i64, i, i, i, i64, i64, i64, p]
        lib.trs_pooled_row_gather.restype = i
        lib._trs_typed = True
    return lib


def wrap_ids(idx: torch.Tensor, rows: int):
    """``jnp.take``'s index rule for a table of ``rows`` rows: ``(row, valid)``
    where an id in ``[-rows, 0)`` counts from the end, and ``valid`` marks
    the ids in ``[-rows, rows)`` (``row`` is 0 where it is False)."""
    valid = (idx >= -rows) & (idx < rows)
    row = torch.where(idx < 0, idx + rows, idx)
    return torch.where(valid, row, torch.zeros_like(row)), valid


def row_gather_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: ``index_select`` of the wrapped ids, NaN rows for the
    ids outside ``[-rows, rows)``."""
    row, valid = wrap_ids(idx, src.shape[0])
    out = src.index_select(0, row)
    return out.masked_fill_(~valid[:, None], float("nan"))


def row_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]`` for a 2-D float32 or bfloat16 ``src``.

    On the card the grid is as many blocks as the card holds at once; a warp
    reads a chunk of 32 consecutive ids once, issues 4 row reads per lane
    before it stores any, and loads its next chunk's ids under those reads.
    Nothing is allocated but the output, and nothing is read back.

    Args:
        src: ``(rows, width)`` float32 or bfloat16 (a bf16 table of the
            dense route): the ``(R, P*E)`` stored table, its ``(Vp*P, E)``
            logical view (``packed_lookup``), or a grad stream to permute.
        idx: ``(num,)`` int32 or int64 row ids.

    Returns:
        ``(num, width)`` of ``src``'s dtype.  Ids wrap as ``jnp.take`` wraps
        them: an id in ``[-rows, 0)`` reads row ``rows + id``, and the row of
        an id outside ``[-rows, rows)`` is NaN, as the JAX lookup's fill mode
        gives.
    """
    _k.require(src.dim() == 2 and src.dtype in ROW_DTYPES,
               f"src must be (rows, width) float32 or bfloat16, got {tuple(src.shape)} "
               f"{src.dtype}")
    _k.require(idx.dim() == 1 and idx.dtype in INDEX_DTYPES,
               f"idx must be (num,) int32 or int64, got {tuple(idx.shape)} {idx.dtype}")
    if _k.device_kind(src, idx) == "cpu":
        return row_gather_plain(src, idx)
    _k.require(src.is_contiguous() and idx.is_contiguous(), "inputs must be contiguous")
    rows, width = src.shape
    _k.require(width < 2**23, "width too large for the kernel's 32-bit offsets")
    num = idx.shape[0]
    out = torch.empty(num, width, dtype=src.dtype, device=src.device)
    if num == 0 or width == 0:
        return out
    status = _lib().trs_row_gather(
        _k.ptr(src), _k.ptr(idx), idx.element_size(), _k.ptr(out), num, rows, width,
        src.element_size(), _k.current_stream(src.device),
    )
    _k.check_status(status, "row_gather")
    row_gather.launches += 1
    return out


row_gather.launches = 0


def pooled_row_gather_plain(table: torch.Tensor, ids: torch.Tensor, starts: torch.Tensor,
                            lo: int, hi: int, base: int) -> torch.Tensor:
    """Plain version: the rows of the served ids (zeros elsewhere), each bag
    summed slot by slot from +0, as the kernel sums it."""
    b, s = ids.shape
    e = table.shape[1]
    idx = ids.to(torch.int64)
    ok = (idx >= lo) & (idx < hi)
    local = torch.where(ok, idx - base, torch.zeros_like(idx))
    rows = table.index_select(0, local.reshape(-1)).reshape(b, s, e)
    rows = torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    bounds = starts.tolist()
    out = rows.new_zeros(b, len(bounds) - 1, e)
    for n, (s0, s1) in enumerate(zip(bounds, bounds[1:])):
        acc = out[:, n]
        for k in range(s0, s1):
            acc = acc + rows[:, k]
        out[:, n] = acc
    return out


def pooled_row_gather(table: torch.Tensor, ids: torch.Tensor, starts: torch.Tensor,
                      lo: int = 0, hi: Optional[int] = None, base: int = 0) -> torch.Tensor:
    """Bag sums of a multi-hot lookup: ``out[b, n] = sum of table[ids[b, s] -
    base]`` over the slots ``s`` of bag ``n`` whose id lies in ``[lo, hi)``.

    On the card one warp sums a bag, in slot order, with several row reads in
    flight a lane; the grid is as many blocks as the card holds at once.
    Nothing is allocated but the output, and no ``(B*S, E)`` rows are
    written.

    Args:
        table: ``(rows, E)`` float32: the logical table, or a rank's rows of
            it whose first row is logical row ``base``.
        ids: ``(B, S)`` int32 or int64 logical ids.
        starts: ``(N + 1,)`` int32 slot offsets of the ``N`` bags of an
            example, ascending from 0 to ``S``, on the table's device.
        lo, hi: the logical rows served (default: all of ``table``'s,
            ``[base, base + rows)``); an id outside them adds nothing.
        base: the logical row of ``table``'s first row.

    Returns:
        ``(B, N, E)`` float32.
    """
    _k.require(table.dim() == 2 and table.dtype == torch.float32,
               f"table must be (rows, E) float32, got {tuple(table.shape)} {table.dtype}")
    _k.require(ids.dim() == 2 and ids.dtype in INDEX_DTYPES,
               f"ids must be (B, S) int32 or int64, got {tuple(ids.shape)} {ids.dtype}")
    _k.require(starts.dim() == 1 and starts.dtype == torch.int32 and starts.shape[0] >= 2,
               f"starts must be (N + 1,) int32, got {tuple(starts.shape)} {starts.dtype}")
    if hi is None:
        hi = base + table.shape[0]
    _k.require(base <= lo and hi <= base + table.shape[0],
               f"served rows [{lo}, {hi}) lie outside the table's [{base}, "
               f"{base + table.shape[0]})")
    if _k.device_kind(table, ids, starts) == "cpu":
        return pooled_row_gather_plain(table, ids, starts, lo, hi, base)
    _k.require(table.is_contiguous() and ids.is_contiguous() and starts.is_contiguous(),
               "inputs must be contiguous")
    b, s = ids.shape
    n = starts.shape[0] - 1
    e = table.shape[1]
    out = torch.empty(b, n, e, dtype=torch.float32, device=table.device)
    if b == 0:
        return out
    status = _lib().trs_pooled_row_gather(
        _k.ptr(table), _k.ptr(ids), ids.element_size(), _k.ptr(starts), _k.ptr(out), b, n, s, e,
        lo, hi, base, _k.current_stream(table.device))
    _k.check_status(status, "pooled_row_gather")
    pooled_row_gather.launches += 1
    return out


pooled_row_gather.launches = 0


def unique_stored_gather_plain(table: torch.Tensor, uids: torch.Tensor,
                               embed_size: int) -> torch.Tensor:
    """Plain version: ``index_select`` of the stored rows of the clamped
    ids (rows of the sentinel tail hold the last stored row)."""
    pack = table.shape[1] // embed_size
    ids = uids.long().clamp(0, table.shape[0] * pack - 1)
    return table.index_select(0, ids // pack)


def unique_stored_gather(table: torch.Tensor, uids: torch.Tensor,
                         embed_size: int) -> torch.Tensor:
    """Compact stored-row gather from a packed table: ``out[i] =
    table[uids[i] // P]``.

    On the card the grid is as many blocks as the card holds at once, not
    one thread per element of ``M``: each warp reads the stored rows of a
    few consecutive ids before it writes them, strides on over the stream,
    and stops at its first sentinel (the valid ids are a prefix).  Nothing
    is read back to the host.

    Args:
        table: ``(Vp, P*E)`` float32 packed table.
        uids: ``(M,)`` int32 ascending unique logical ids, padded with a
            sentinel ``>= Vp*P`` (the valid ids are a prefix).
        embed_size: E.

    Returns:
        ``(M, P*E)`` float32: row ``i`` is the stored row holding logical id
        ``uids[i]`` for the valid prefix; the rows past it are unspecified,
        as in the JAX function.  The in-row slot (``uids % P``) is selected
        outside.
    """
    _k.require(table.dim() == 2 and table.dtype == torch.float32,
               f"table must be (Vp, P*E) float32, got {tuple(table.shape)} {table.dtype}")
    _k.require(uids.dim() == 1 and uids.dtype == torch.int32,
               f"uids must be (M,) int32, got {tuple(uids.shape)} {uids.dtype}")
    vp, width = table.shape
    _k.require(embed_size >= 1 and width % embed_size == 0,
               f"table width {width} is not a multiple of embed_size {embed_size}")
    _k.require(vp >= 1, "table must have a row")
    if _k.device_kind(table, uids) == "cpu":
        return unique_stored_gather_plain(table, uids, embed_size)
    _k.require(table.is_contiguous() and uids.is_contiguous(), "inputs must be contiguous")
    pack = width // embed_size
    num = uids.shape[0]
    out = torch.empty(num, width, dtype=torch.float32, device=table.device)
    if num == 0:
        return out
    status = _lib().trs_unique_stored_gather(
        _k.ptr(table), _k.ptr(uids), _k.ptr(out), num, vp * pack, pack, width,
        _k.current_stream(table.device),
    )
    _k.check_status(status, "unique_stored_gather")
    unique_stored_gather.launches += 1
    return out


unique_stored_gather.launches = 0

__all__ = ["ROW_DTYPES", "pooled_row_gather", "pooled_row_gather_plain", "row_gather",
           "row_gather_plain", "unique_stored_gather", "unique_stored_gather_plain", "wrap_ids"]
