"""DCN-v2's low-rank cross: one layer's combine and its backward, each in one
pass.

Written in CUDA C++ in ``csrc/cross.cu``, whose header says why it exists (no
TPU kernel is its counterpart), what bounds it on the card and which
roundings it takes.  :func:`low_rank_cross_forward` makes ``x' = x0 * (y +
b) + x`` and, where asked, ``x'``'s copy in ``y``'s dtype, which the next
layer's V product reads; :func:`low_rank_cross_backward` makes the gradients
of ``x0``, ``x``, ``y`` and ``b`` from those of ``x'``, its copy and ``x0`` as
the later layers read it.  The autograd Function that joins them is
``ops.interactions.low_rank_cross``.

Each wrapper takes its plain version (``*_plain``: the same operations, one
PyTorch op at a time, which is the kernel's specification) for tensors on the
CPU, launches its kernel for tensors on the card, and raises on anything
else: a mix of devices, a dtype other than float32 or bf16, a shape or
layout the kernel does not take.  ``launches`` on each wrapper counts its
calls that launched the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from torecsys_tpu_torch.ops import kernels as _k

SOURCE = "cross.cu"
KINDS = {torch.float32: 0, torch.bfloat16: 1}  # csrc Kind
ROWS_PER_BLOCK = 64    # rows a block (csrc kRows): the bias partials' row blocks
COLS_PER_BLOCK = 128   # columns a block (csrc kCols)
VEC = 8                # consecutive columns a thread moves (csrc kVec)
VECTOR_BYTES = 16
MAX_COL_BLOCKS = 65535  # the grid's y dimension


def _lib():
    lib = _k.load_library(SOURCE)
    if not getattr(lib, "_trs_typed", False):
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.trs_low_rank_cross_forward.argtypes = [i, i, p, p, p, p, p, p, i64, i64, i, p]
        lib.trs_low_rank_cross_forward.restype = i
        lib.trs_low_rank_cross_backward.argtypes = [i, i, p, p, p, p, p, p, i, p, p, p, p, p,
                                                    i64, i64, i, p]
        lib.trs_low_rank_cross_backward.restype = i
        for name in ("trs_cross_rows_per_block", "trs_cross_cols_per_block"):
            getattr(lib, name).restype = i
        built = (lib.trs_cross_rows_per_block(), lib.trs_cross_cols_per_block())
        if built != (ROWS_PER_BLOCK, COLS_PER_BLOCK):
            raise RuntimeError(f"{SOURCE} tiles (rows, columns) {built}, the wrapper "
                               f"{(ROWS_PER_BLOCK, COLS_PER_BLOCK)}")
        lib._trs_typed = True
    return lib


def vector_path(cols: int, *tensors: Optional[torch.Tensor]) -> bool:
    """Whether the kernel moves 16-byte vectors: ``cols`` a multiple of 8
    and every given tensor starting on a 16-byte boundary."""
    return cols % VEC == 0 and all(t.data_ptr() % VECTOR_BYTES == 0
                                   for t in tensors if t is not None)


def _arg(t: Optional[torch.Tensor]):
    return None if t is None else _k.ptr(t)


def _check(x0: torch.Tensor, y: torch.Tensor, bias: Optional[torch.Tensor],
           **same: Optional[torch.Tensor]) -> None:
    """The tensors' dtypes and shapes: ``x0`` ``(B, D)``, ``y`` ``(B, D)``,
    ``bias`` ``(D,)`` in ``y``'s dtype, the ``same`` ones as ``x0`` (a
    ``_copy`` one in ``y``'s dtype)."""
    _k.require(x0.dim() == 2 and y.shape == x0.shape,
               f"x0 and y must be (B, D) alike, got {tuple(x0.shape)} and {tuple(y.shape)}")
    _k.require(bias is None or (bias.shape == (x0.shape[1],) and bias.dtype == y.dtype),
               f"bias must be (D,) in y's dtype {y.dtype}")
    for name, t in same.items():
        want = y.dtype if name.endswith("_copy") else x0.dtype
        _k.require(t is None or (t.shape == x0.shape and t.dtype == want),
                   f"{name} must be {tuple(x0.shape)} {want}")


def _require_width(cols: int) -> None:
    _k.require(-(-cols // COLS_PER_BLOCK) <= MAX_COL_BLOCKS, f"D = {cols} is too wide")


def _card_check(*tensors: Optional[torch.Tensor]) -> None:
    given = [t for t in tensors if t is not None]
    _k.require(all(t.dtype in KINDS for t in given), "the kernel takes float32 and bf16 only")
    _k.require(all(t.is_contiguous() for t in given), "inputs must be contiguous")


def low_rank_cross_forward_plain(x0: torch.Tensor, x: Optional[torch.Tensor], y: torch.Tensor,
                                 bias: Optional[torch.Tensor] = None,
                                 copy: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version: ``p = y + b`` in ``y``'s dtype, ``x' = x0 *
    p.to(x0.dtype) + x`` (``x`` None: ``x0``), and ``x'.to(y.dtype)`` where
    ``copy``."""
    p = y if bias is None else y + bias
    out = x0 * p.to(x0.dtype) + (x0 if x is None else x)
    return out, out.to(y.dtype) if copy else None


def low_rank_cross_forward(x0: torch.Tensor, x: Optional[torch.Tensor], y: torch.Tensor,
                           bias: Optional[torch.Tensor] = None,
                           copy: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer's combine: ``(x', x'.to(y.dtype) or None)``, the same bits
    as :func:`low_rank_cross_forward_plain`.

    Args:
        x0: ``(B, D)`` float32 or bf16, the cross's input.
        x: the layer's input, as ``x0``; None where it is ``x0`` itself.
        y: ``(B, D)`` float32 or bf16, the U product; with ``bias`` its
            rounded product, the bias still to be added in its dtype.
        bias: ``(D,)`` in ``y``'s dtype, or None.
        copy: also return ``x'`` in ``y``'s dtype.
    """
    _check(x0, y, bias, x=x)
    if _k.device_kind(*(t for t in (x0, x, y, bias) if t is not None)) == "cpu":
        return low_rank_cross_forward_plain(x0, x, y, bias, copy)
    _card_check(x0, x, y, bias)
    out = torch.empty_like(x0)
    out_copy = torch.empty_like(y) if copy else None
    if out.numel():
        _require_width(x0.shape[1])
        _forward_launch(x0, x0 if x is None else x, y, bias, out, out_copy)
        low_rank_cross_forward.launches += 1
    return out, out_copy


low_rank_cross_forward.launches = 0


def _forward_launch(x0, x, y, bias, out, out_copy) -> None:
    """The kernel's launch on the wrapper's tensors (``x`` is ``x0``'s
    tensor in the first layer)."""
    rows, cols = x0.shape
    vec = vector_path(cols, x0, x, y, bias, out, out_copy)
    status = _lib().trs_low_rank_cross_forward(
        KINDS[x0.dtype], KINDS[y.dtype], _arg(x0), _arg(x), _arg(y), _arg(bias), _arg(out),
        _arg(out_copy), rows, cols, int(vec), _k.current_stream(x0.device))
    _k.check_status(status, "low_rank_cross_forward")


def low_rank_cross_backward_plain(
        grad: torch.Tensor, grad_copy: Optional[torch.Tensor], grad_x0: Optional[torch.Tensor],
        x0: torch.Tensor, y: torch.Tensor, bias: Optional[torch.Tensor] = None,
        x_is_x0: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor, Optional[torch.Tensor]]:
    """Plain version: ``Gt = grad + grad_copy.to(grad.dtype)`` (``grad``
    where there is no ``grad_copy``), then autograd's products through
    :func:`low_rank_cross_forward_plain`: ``(dx0, dx, dy, dbias)``; ``dx0``
    also takes ``dx`` where ``x_is_x0`` (``dx`` None then), then
    ``grad_x0``, the later layers' gradient of ``x0``, where given; ``dbias``
    is None without a bias."""
    gt = grad if grad_copy is None else grad + grad_copy.to(grad.dtype)
    p = y if bias is None else y + bias
    dx0 = gt * p.to(x0.dtype)
    dy = (gt * x0).to(y.dtype)
    dx = gt
    if x_is_x0:
        dx0, dx = dx0 + gt, None
    if grad_x0 is not None:
        dx0 = dx0 + grad_x0
    return dx0, dx, dy, None if bias is None else dy.sum(0)


def low_rank_cross_backward(
        grad: torch.Tensor, grad_copy: Optional[torch.Tensor], grad_x0: Optional[torch.Tensor],
        x0: torch.Tensor, y: torch.Tensor, bias: Optional[torch.Tensor] = None,
        x_is_x0: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor, Optional[torch.Tensor]]:
    """One layer's backward: ``(dx0, dx, dy, dbias)`` as
    :func:`low_rank_cross_backward_plain`, in one pass and the bias' second
    pass (its sums, and ``dx0``'s, in another order).  ``grad`` (in ``x0``'s
    dtype) and ``grad_copy`` (in ``y``'s, or None) are the gradients of the
    forward's two outputs, ``grad_x0`` (in ``x0``'s, or None) that of ``x0``
    as the later layers read it; ``x0``, ``y`` and ``bias`` the forward's
    inputs.  Without ``grad_copy`` ``dx`` is ``grad`` itself, nothing
    written."""
    _check(x0, y, bias, grad=grad, grad_copy=grad_copy, grad_x0=grad_x0)
    given = [t for t in (grad, grad_copy, grad_x0, x0, y, bias) if t is not None]
    if _k.device_kind(*given) == "cpu":
        return low_rank_cross_backward_plain(grad, grad_copy, grad_x0, x0, y, bias, x_is_x0)
    _card_check(*given)
    rows, cols = x0.shape
    dx0 = torch.empty_like(x0)
    dx = None if x_is_x0 else (grad if grad_copy is None else torch.empty_like(x0))
    dy = torch.empty_like(y)
    dbias = partials = None
    if bias is not None:
        dbias = torch.empty_like(bias)
        partials = torch.empty(-(-rows // ROWS_PER_BLOCK), cols, dtype=torch.float32,
                               device=x0.device)
    if dx0.numel():
        _require_width(cols)
        _backward_launch(grad, grad_copy, grad_x0, x0, y, bias, x_is_x0, dx0,
                         None if dx is grad else dx, dy, partials, dbias)
        low_rank_cross_backward.launches += 1
    elif dbias is not None:
        dbias.zero_()
    return dx0, dx, dy, dbias


low_rank_cross_backward.launches = 0


def _backward_launch(grad, grad_copy, grad_x0, x0, y, bias, x_is_x0, dx0, dx, dy, partials,
                     dbias) -> None:
    """The kernel's launch on the wrapper's tensors (``dx`` None: not
    written)."""
    rows, cols = x0.shape
    vec = vector_path(cols, grad, grad_copy, grad_x0, x0, y, bias, dx0, dx, dy)
    status = _lib().trs_low_rank_cross_backward(
        KINDS[x0.dtype], KINDS[y.dtype], _arg(grad), _arg(grad_copy), _arg(grad_x0), _arg(x0),
        _arg(y), _arg(bias), int(x_is_x0), _arg(dx0), _arg(dx), _arg(dy), _arg(partials),
        _arg(dbias), rows, cols, int(vec), _k.current_stream(x0.device))
    _k.check_status(status, "low_rank_cross_backward")


__all__ = ["COLS_PER_BLOCK", "ROWS_PER_BLOCK", "low_rank_cross_backward",
           "low_rank_cross_backward_plain", "low_rank_cross_forward",
           "low_rank_cross_forward_plain", "vector_path"]
