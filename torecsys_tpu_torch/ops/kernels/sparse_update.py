"""Sparse embedding update kernels: segment-sums and row-wise updates.

Counterpart of ``torecsys_tpu/ops/pallas/sparse_update.py``.  Four kernels,
written in CUDA C++ for Hopper in ``csrc/sparse_update.cu`` (its header says
what bounds each on the card and how the design answers it):

* :func:`widen_segment_sum` replaces ``sorted_widen_segment_sum``;
* :func:`segment_sum_wide` replaces ``sorted_segment_sum_wide``;
* :func:`fused_rowwise_update` replaces ``fused_rowwise_update``;
* :func:`fused_sorted_dedup_update` replaces ``fused_sorted_dedup_update``,
  the on-device route's dedup, segment sum and update in one pass.

Each wrapper takes the plain PyTorch version (``*_plain``) for tensors on the
CPU, launches its kernel for tensors on the card, and raises on anything
else: a mix of devices, a wrong dtype, shape or layout.  ``launches`` on each
wrapper counts its calls that launch the kernel (the tiled kernels launch
two a call, a tile pass and a fix-up pass) and nothing else.

One tile scheme serves three kernels: the two segment sums and the fused
dedup.  The stream is cut by position: a warp sums ``SEGSUM_TILE``
consecutive positions, a block ``SEGSUM_WARPS`` such tiles, and a fix-up
pass finishes the groups that cross block tiles.  The segment sums write
each group's sum; the fused dedup applies the row-wise rule to its stored
row in the pass that finishes the sum.  Each element is summed in an order
that this tiling alone fixes, the same in all three, so two launches give
the same bits and the fused dedup's table and slots equal those of the
default combine (a segment sum, then :func:`fused_rowwise_update`) bit for
bit.  Where every partial sum is exact (values on a coarse grid) the sums
are the plain version's bit for bit; otherwise they may differ from the
in-order sum by rounding where a group crosses a tile edge, within
``(L - 1) * 2**-24 * sum|g|`` of the exact sum for a group of ``L``
positions.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple, Union

import torch

from torecsys_tpu_torch.ops import kernels as _k

SOURCE = "sparse_update.cu"
RULES = {"adam": 0, "adagrad": 1, "sgd": 2}
SEGSUM_TILE = 32   # positions a warp sums in order (csrc kSegTile)
SEGSUM_WARPS = 8   # warp tiles per block tile (csrc kSegWarps)


def _lib():
    lib = _k.load_library(SOURCE)
    if not getattr(lib, "_trs_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.trs_widen_segment_sum.argtypes = [p, p, p, p, p, i, i, i, p]
        lib.trs_widen_segment_sum.restype = i
        lib.trs_fused_rowwise_update.argtypes = [p, p, p, p, p, i, i, p, i, i, p]
        lib.trs_fused_rowwise_update.restype = i
        lib.trs_fused_sorted_dedup_update.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        lib.trs_fused_sorted_dedup_update.restype = i
        lib.trs_segment_sum_wide.argtypes = [p, p, p, p, i, i, p]
        lib.trs_segment_sum_wide.restype = i
        lib.trs_segsum_tile.restype = i
        lib.trs_segsum_warps.restype = i
        tiling = (lib.trs_segsum_tile(), lib.trs_segsum_warps())
        if tiling != (SEGSUM_TILE, SEGSUM_WARPS):
            raise RuntimeError(f"{SOURCE} tiles the segment sums as {tiling}, the wrapper "
                               f"as {(SEGSUM_TILE, SEGSUM_WARPS)}")
        lib._trs_typed = True
    return lib


# ---- widened segment-sum ----------------------------------------------------

def _segsum_scratch(m: int, w: int, device) -> torch.Tensor:
    """The tiled kernels' scratch: a ``cont`` and a ``head`` partial row per
    block tile."""
    n_tiles = -(-m // (SEGSUM_TILE * SEGSUM_WARPS))
    return torch.empty(2 * n_tiles, w, dtype=torch.float32, device=device)


def widen_segment_sum_plain(g_sorted: torch.Tensor, lo: torch.Tensor,
                            seg: torch.Tensor, pack: int) -> torch.Tensor:
    """Plain version: widen each narrow row into its in-row slot, then sum
    the wide rows per segment in position order (``index_add_``)."""
    m, e = g_sorted.shape
    wide = torch.zeros(m, pack, e, dtype=g_sorted.dtype, device=g_sorted.device)
    wide[torch.arange(m, device=g_sorted.device), lo.long()] = g_sorted
    out = torch.zeros(m, pack * e, dtype=g_sorted.dtype, device=g_sorted.device)
    return out.index_add_(0, seg.long(), wide.reshape(m, pack * e))


def widen_segment_sum(g_sorted: torch.Tensor, lo: torch.Tensor,
                      seg: torch.Tensor, pack: int) -> torch.Tensor:
    """Compact per-segment WIDE sums of a sorted narrow grad stream.

    Args:
        g_sorted: ``(M, E)`` float32 per-slot grads in id order.
        lo: ``(M,)`` int32 in-stored-row slot (``id % pack``), in ``[0, pack)``.
        seg: ``(M,)`` int32 nondecreasing stored-row segment ids, dense from 0
            (``cumsum(first) - 1``, the presort's ``seg``).
        pack: logical rows per stored row ``P``.

    Returns:
        ``(M, P*E)`` float32: row ``s`` is the widened sum of the positions
        with ``seg == s``; rows past the last segment are zero.
    """
    _k.require(g_sorted.dim() == 2, f"g_sorted must be (M, E), got {tuple(g_sorted.shape)}")
    m, e = g_sorted.shape
    _k.require(g_sorted.dtype == torch.float32, f"g_sorted must be float32, got {g_sorted.dtype}")
    _k.require(lo.shape == (m,) and seg.shape == (m,), "lo and seg must be (M,)")
    _k.require(lo.dtype == torch.int32 and seg.dtype == torch.int32, "lo and seg must be int32")
    _k.require(pack >= 1, f"pack must be >= 1, got {pack}")
    if _k.device_kind(g_sorted, lo, seg) == "cpu":
        return widen_segment_sum_plain(g_sorted, lo, seg, pack)
    _k.require(all(t.is_contiguous() for t in (g_sorted, lo, seg)), "inputs must be contiguous")
    _k.require(m * pack * e < 2**31 and m < 2**30, "stream too large for int32 indexing")
    out = torch.empty(m, pack * e, dtype=torch.float32, device=g_sorted.device)
    if m == 0:
        return out
    scratch = _segsum_scratch(m, pack * e, g_sorted.device)
    status = _lib().trs_widen_segment_sum(
        _k.ptr(g_sorted), _k.ptr(lo), _k.ptr(seg), _k.ptr(scratch), _k.ptr(out),
        m, e, pack, _k.current_stream(g_sorted.device),
    )
    _k.check_status(status, "widen_segment_sum")
    widen_segment_sum.launches += 1
    return out


widen_segment_sum.launches = 0


# ---- segment-sum of an already-wide stream (pack == 1) ----------------------

def segment_sum_wide_plain(wide: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Plain version: sum the rows per segment in position order
    (``index_add_``)."""
    out = torch.zeros_like(wide)
    return out.index_add_(0, seg.long(), wide)


def segment_sum_wide(wide: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Compact per-segment sums of a sorted, already-wide stream.

    Args:
        wide: ``(M, W)`` float32 rows in id order.
        seg: ``(M,)`` int32 nondecreasing segment ids, dense from 0 (the
            presort's ``seg``).

    Returns:
        ``(M, W)`` float32: row ``s`` is the sum of the rows with
        ``seg == s``; rows past the last segment are zero.
    """
    _k.require(wide.dim() == 2, f"wide must be (M, W), got {tuple(wide.shape)}")
    m, w = wide.shape
    _k.require(wide.dtype == torch.float32, f"wide must be float32, got {wide.dtype}")
    _k.require(seg.shape == (m,) and seg.dtype == torch.int32, "seg must be (M,) int32")
    if _k.device_kind(wide, seg) == "cpu":
        return segment_sum_wide_plain(wide, seg)
    _k.require(wide.is_contiguous() and seg.is_contiguous(), "inputs must be contiguous")
    _k.require(m < 2**30, "stream too large for int32 indexing")
    out = torch.empty_like(wide)
    if m == 0:
        return out
    scratch = _segsum_scratch(m, w, wide.device)
    status = _lib().trs_segment_sum_wide(
        _k.ptr(wide), _k.ptr(seg), _k.ptr(scratch), _k.ptr(out), m, w,
        _k.current_stream(wide.device),
    )
    _k.check_status(status, "segment_sum_wide")
    segment_sum_wide.launches += 1
    return out


segment_sum_wide.launches = 0


# ---- fused row-wise update --------------------------------------------------

def fused_rowwise_update_plain(uids: torch.Tensor, gsum: torch.Tensor,
                               table: torch.Tensor, slots: Sequence[torch.Tensor],
                               hyper: torch.Tensor, rule: str, n_valid=None):
    """Plain version: gather the valid rows, apply the rule with the same
    operation order as the kernel, and scatter them back in place.  Like
    the kernel it skips a uid outside ``[0, R)``; a device ``n_valid`` is
    read on the host."""
    n = uids.shape[0] if n_valid is None else int(n_valid)
    keep = (uids[:n] >= 0) & (uids[:n] < table.shape[0])
    idx = uids[:n][keep].long()
    g = gsum[:n][keep]
    row = table.index_select(0, idx)
    lr, b1, b2, eps, wd, bc1, bc2 = hyper.unbind(0)
    if rule == "adam":
        mv = slots[0]
        mv_u = mv.index_select(0, idx)
        m_new = b1 * mv_u[:, 0] + (1.0 - b1) * g
        v_new = b2 * mv_u[:, 1] + (1.0 - b2) * g * g
        upd = lr * ((m_new * bc1) / (torch.sqrt(v_new * bc2) + eps))
        upd = upd + lr * wd * row
        mv.index_copy_(0, idx, torch.stack([m_new, v_new], dim=1))
    elif rule == "adagrad":
        v = slots[0]
        v_new = v.index_select(0, idx) + g * g
        upd = lr * g * torch.rsqrt(v_new + eps)
        v.index_copy_(0, idx, v_new)
    else:  # lr only: table_grad (ops/embedding.py) sums with it at lr = -1
        upd = lr * g
    table.index_copy_(0, idx, row - upd)
    return table, list(slots)


def _slot_shapes(rule: str, rows: int, w: int) -> Tuple[Tuple[int, ...], ...]:
    if rule == "adam":
        return ((rows, 2, w),)
    if rule == "adagrad":
        return ((rows, w),)
    return ()


def fused_rowwise_update(uids: torch.Tensor, gsum: torch.Tensor,
                         table: torch.Tensor, slots: Sequence[torch.Tensor],
                         hyper: torch.Tensor, rule: str,
                         n_valid: Optional[Union[int, torch.Tensor]] = None):
    """Apply a row-wise optimizer rule to the unique touched rows, IN PLACE.

    ``table`` and ``slots`` are updated where they lie (the port's tables and
    optimizer slots are mutable); they are also returned, as the JAX
    function returns its aliased outputs.

    Args:
        uids: ``(M,)`` int32 unique stored-row ids, ascending; the first
            ``n_valid`` are rows of ``table`` (the rest is a sentinel tail).
        gsum: ``(M, W)`` float32 summed gradient per unique row.
        table: ``(R, W)`` float32 stored table.
        slots: ``(mv,)`` of ``(R, 2, W)`` for adam, ``(v,)`` of ``(R, W)`` for
            adagrad, ``()`` for sgd.
        hyper: ``(7,)`` float32 on the table's device: lr, b1, b2, eps,
            weight_decay, 1/(1-b1^t), 1/(1-b2^t).
        rule: 'adam' | 'adagrad' | 'sgd'.
        n_valid: the number of valid leading ``uids``: a host int (it sizes
            the grid), a 0-d int32 tensor on the table's device (the grid
            covers all ``M`` uids and the kernel stops at ``*n_valid``;
            nothing is read back), or None for all ``M``.  A uid outside
            ``[0, R)`` is skipped in any case.

    Returns:
        ``(table, [slots...])``.
    """
    _k.require(rule in RULES, f"rule must be one of {sorted(RULES)}, got {rule!r}")
    _k.require(table.dim() == 2 and table.dtype == torch.float32, "table must be (R, W) float32")
    rows, w = table.shape
    m = uids.shape[0]
    _k.require(uids.dim() == 1 and uids.dtype == torch.int32, "uids must be (M,) int32")
    _k.require(gsum.shape == (m, w) and gsum.dtype == torch.float32, "gsum must be (M, W) float32")
    _k.require(hyper.shape == (7,) and hyper.dtype == torch.float32, "hyper must be (7,) float32")
    shapes = _slot_shapes(rule, rows, w)
    _k.require(len(slots) == len(shapes), f"rule {rule!r} takes {len(shapes)} slot array(s)")
    for s, shape in zip(slots, shapes):
        _k.require(tuple(s.shape) == shape and s.dtype == torch.float32,
                   f"slot must be {shape} float32, got {tuple(s.shape)} {s.dtype}")
    on_device = isinstance(n_valid, torch.Tensor)
    if on_device:
        _k.require(n_valid.dim() == 0 and n_valid.dtype == torch.int32,
                   f"a device n_valid must be a 0-d int32 tensor, got "
                   f"{tuple(n_valid.shape)} {n_valid.dtype}")
        n_rows = m
    else:
        n_rows = m if n_valid is None else int(n_valid)
        _k.require(0 <= n_rows <= m, f"n_valid={n_rows} outside [0, {m}]")
    counted = (n_valid,) if on_device else ()
    if _k.device_kind(uids, gsum, table, hyper, *slots, *counted) == "cpu":
        return fused_rowwise_update_plain(uids, gsum, table, slots, hyper, rule, n_valid)
    _k.require(all(t.is_contiguous() for t in (uids, gsum, table, hyper, *slots)),
               "inputs must be contiguous")
    _k.require(w % 4 == 0, f"row width {w} must be a multiple of 4 (16-byte rows)")
    _k.require(all(t.data_ptr() % 16 == 0 for t in (gsum, table, *slots)),
               "table, gsum and slots must be 16-byte aligned")
    if n_rows == 0:
        return table, list(slots)
    slot_ptr = _k.ptr(slots[0]) if slots else ctypes.c_void_p(0)
    count_ptr = _k.ptr(n_valid) if on_device else ctypes.c_void_p(0)
    status = _lib().trs_fused_rowwise_update(
        _k.ptr(uids), _k.ptr(gsum), _k.ptr(table), slot_ptr, _k.ptr(hyper),
        RULES[rule], n_rows, count_ptr, rows, w, _k.current_stream(table.device),
    )
    _k.check_status(status, "fused_rowwise_update")
    fused_rowwise_update.launches += 1
    return table, list(slots)


fused_rowwise_update.launches = 0


# ---- fused dedup + segment sum + row-wise update ----------------------------

def fused_sorted_dedup_update_plain(sorted_ids: torch.Tensor, g_sorted: torch.Tensor,
                                    table: torch.Tensor, slots: Sequence[torch.Tensor],
                                    hyper: torch.Tensor, pack: int, rule: str):
    """Plain version: stored-row segments by prefix sum, their unique rows
    by scatter, the widened sums (:func:`widen_segment_sum_plain`), then
    :func:`fused_rowwise_update_plain` over the segments."""
    m = sorted_ids.shape[0]
    if m == 0:
        return table, list(slots)
    hi = sorted_ids // pack
    first = torch.ones(m, dtype=torch.bool, device=hi.device)
    first[1:] = hi[1:] != hi[:-1]
    seg = torch.cumsum(first, 0, dtype=torch.int32) - 1
    uids = torch.full_like(hi, table.shape[0]).scatter_(0, seg.long(), hi)
    gsum = widen_segment_sum_plain(g_sorted, sorted_ids % pack, seg, pack)
    return fused_rowwise_update_plain(uids, gsum, table, slots, hyper, rule, seg[-1] + 1)


def fused_sorted_dedup_update(sorted_ids: torch.Tensor, g_sorted: torch.Tensor,
                              table: torch.Tensor, slots: Sequence[torch.Tensor],
                              hyper: torch.Tensor, pack: int, rule: str):
    """Dedup, widen, segment-sum and apply a row-wise rule in one pass, IN
    PLACE.

    On the card: the segment sums' position tiles (two launches), keyed by
    the stored row ``id // pack``.  A group that lies inside a block tile is
    summed and its row updated by the tile pass; one that crosses block
    tiles by the fix-up pass.  No atomics, and every stored row has one
    writer.  The result equals the default combine's
    (:func:`widen_segment_sum`, or :func:`segment_sum_wide` at ``pack ==
    1``, then :func:`fused_rowwise_update`) on the same stream bit for bit.
    The lookup's backward (``ops/embedding.py`` ``table_grad``) sums a
    cotangent per row with it: rule ``sgd`` at ``lr = -1`` into a zero table,
    which relies on ``sgd`` being ``r - lr * g`` and reading no other hyper.

    Args:
        sorted_ids: ``(M,)`` int32 LOGICAL row ids, ascending (duplicates
            allowed: this is the dedup).  A stored row ``id // pack`` outside
            ``[0, R)``, such as a sentinel tail ``>= R * pack``, is summed
            but never written.
        g_sorted: ``(M, E)`` float32 narrow per-slot grads in the same order.
        table: ``(R, pack * E)`` float32 packed stored table.
        slots: as for :func:`fused_rowwise_update`.
        hyper: ``(7,)`` float32 on the table's device.
        pack: logical rows per stored row ``P``.
        rule: 'adam' | 'adagrad' | 'sgd'.

    Returns:
        ``(table, [slots...])``, updated where they lie.
    """
    _k.require(rule in RULES, f"rule must be one of {sorted(RULES)}, got {rule!r}")
    _k.require(g_sorted.dim() == 2 and g_sorted.dtype == torch.float32,
               "g_sorted must be (M, E) float32")
    m, e = g_sorted.shape
    _k.require(sorted_ids.shape == (m,) and sorted_ids.dtype == torch.int32,
               "sorted_ids must be (M,) int32")
    _k.require(pack >= 1, f"pack must be >= 1, got {pack}")
    _k.require(table.dim() == 2 and table.dtype == torch.float32 and table.shape[1] == pack * e,
               f"table must be (R, {pack * e}) float32, got {tuple(table.shape)} {table.dtype}")
    rows, w = table.shape
    _k.require(hyper.shape == (7,) and hyper.dtype == torch.float32, "hyper must be (7,) float32")
    shapes = _slot_shapes(rule, rows, w)
    _k.require(len(slots) == len(shapes), f"rule {rule!r} takes {len(shapes)} slot array(s)")
    for s, shape in zip(slots, shapes):
        _k.require(tuple(s.shape) == shape and s.dtype == torch.float32,
                   f"slot must be {shape} float32, got {tuple(s.shape)} {s.dtype}")
    if _k.device_kind(sorted_ids, g_sorted, table, hyper, *slots) == "cpu":
        return fused_sorted_dedup_update_plain(sorted_ids, g_sorted, table, slots, hyper,
                                               pack, rule)
    _k.require(all(t.is_contiguous() for t in (sorted_ids, g_sorted, table, hyper, *slots)),
               "inputs must be contiguous")
    _k.require(rows * pack < 2**31 and m < 2**30, "table or stream too large for int32 ids")
    if m == 0:
        return table, list(slots)
    slot_ptr = _k.ptr(slots[0]) if slots else ctypes.c_void_p(0)
    scratch = _segsum_scratch(m, w, table.device)
    status = _lib().trs_fused_sorted_dedup_update(
        _k.ptr(sorted_ids), _k.ptr(g_sorted), _k.ptr(table), slot_ptr, _k.ptr(hyper),
        _k.ptr(scratch), RULES[rule], m, e, pack, rows, _k.current_stream(table.device),
    )
    _k.check_status(status, "fused_sorted_dedup_update")
    fused_sorted_dedup_update.launches += 1
    return table, list(slots)


fused_sorted_dedup_update.launches = 0

__all__ = ["SEGSUM_TILE", "SEGSUM_WARPS", "fused_rowwise_update", "fused_rowwise_update_plain",
           "fused_sorted_dedup_update", "fused_sorted_dedup_update_plain",
           "segment_sum_wide", "segment_sum_wide_plain",
           "widen_segment_sum", "widen_segment_sum_plain"]
