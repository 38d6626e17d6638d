"""Embedding lookup kernel: the row gather.

Counterpart of ``torecsys_tpu/ops/pallas/embedding.py``.  :func:`row_gather`
replaces its ``row_gather`` (``_gather_kernel``), written in CUDA C++ for
Hopper in ``csrc/embedding.cu`` (its header says what bounds it on the card
and how the design answers it).  Its backward, a scatter-add, is no kernel in
the JAX package either; it lives with the lookup in ``ops/embedding.py``.

The wrapper takes the plain PyTorch version (:func:`row_gather_plain`) for
tensors on the CPU, launches the kernel for tensors on the card, and raises
on anything else: a mix of devices, a wrong dtype, shape or layout.
``row_gather.launches`` counts its kernel launches and nothing else.

``unique_stored_gather``, which no module of the JAX package calls, is not
ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from torecsys_tpu_torch.ops import kernels as _k

SOURCE = "embedding.cu"
INDEX_DTYPES = (torch.int32, torch.int64)


def _lib():
    lib = _k.load_library(SOURCE)
    if not getattr(lib, "_trs_typed", False):
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.trs_row_gather.argtypes = [p, p, i, p, i64, i64, i, p]
        lib.trs_row_gather.restype = i
        lib._trs_typed = True
    return lib


def row_gather_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: ``index_select`` of the ids in range, NaN rows for the
    ids outside ``[0, rows)``."""
    valid = (idx >= 0) & (idx < src.shape[0])
    out = src.index_select(0, torch.where(valid, idx, torch.zeros_like(idx)))
    return out.masked_fill_(~valid[:, None], float("nan"))


def row_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]`` for a 2-D float32 ``src``.

    Args:
        src: ``(rows, width)`` float32: the ``(R, P*E)`` stored table, or its
            ``(Vp*P, E)`` logical view (``packed_lookup``).
        idx: ``(num,)`` int32 or int64 row ids.

    Returns:
        ``(num, width)`` float32; the row of an id outside ``[0, rows)`` is
        NaN, as the JAX lookup's fill mode gives.
    """
    _k.require(src.dim() == 2 and src.dtype == torch.float32,
               f"src must be (rows, width) float32, got {tuple(src.shape)} {src.dtype}")
    _k.require(idx.dim() == 1 and idx.dtype in INDEX_DTYPES,
               f"idx must be (num,) int32 or int64, got {tuple(idx.shape)} {idx.dtype}")
    if _k.device_kind(src, idx) == "cpu":
        return row_gather_plain(src, idx)
    _k.require(src.is_contiguous() and idx.is_contiguous(), "inputs must be contiguous")
    rows, width = src.shape
    num = idx.shape[0]
    out = torch.empty(num, width, dtype=torch.float32, device=src.device)
    if num == 0 or width == 0:
        return out
    status = _lib().trs_row_gather(
        _k.ptr(src), _k.ptr(idx), idx.element_size(), _k.ptr(out), num, rows, width,
        _k.current_stream(src.device),
    )
    _k.check_status(status, "row_gather")
    row_gather.launches += 1
    return out


row_gather.launches = 0

__all__ = ["row_gather", "row_gather_plain"]
