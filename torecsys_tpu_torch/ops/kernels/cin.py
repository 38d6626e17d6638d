"""xDeepFM's CIN compression and its backward, the outer product never in
device memory.

Written in CUDA C++ in ``csrc/cin.cu``, whose header says why it exists (no
TPU kernel is its counterpart: the JAX package leaves the CIN to an einsum),
what bounds it on the card (float32 FFMA) and how its tiles follow the
shapes.  :func:`cin_forward` makes ``out[b, o, e] = sum_{h, n} W[o, h, n] *
xk[b, h, e] * x0[b, n, e]``; :func:`cin_backward` the gradients of ``x0``,
``xk`` and ``W`` from that of ``out``.  The autograd Function that joins them
is ``ops.interactions.cin_interaction``.

Each wrapper takes its plain version (``*_plain``: the composition of
PyTorch ops the port ran before, and autograd's backward through it) for
tensors on the CPU, launches its kernels for tensors on the card, and raises
on anything else: a mix of devices, a dtype other than float32 (float64 on
the CPU too, the plain version's reference precision), shapes that do not
fit together, a layout the kernels do not take.  ``launches`` on each
wrapper counts its calls that launched the kernels: the forward kernel (and
W^T's transpose) a forward; the input and the weight kernels (and G^T's
transpose, the weight gradient's split sum) a backward.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from torecsys_tpu_torch.ops import kernels as _k

SOURCE = "cin.cu"
CPU_DTYPES = (torch.float32, torch.float64)


def _lib():
    lib = _k.load_library(SOURCE)
    if not getattr(lib, "_trs_typed", False):
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        dims = [i64, i, i, i, i]
        lib.trs_cin_scratch.argtypes = [i, *dims]
        lib.trs_cin_scratch.restype = i64
        lib.trs_cin_plans.argtypes = [*dims, ctypes.c_char_p, i]
        lib.trs_cin_plans.restype = i
        lib.trs_cin_forward.argtypes = [p, p, p, p, p, *dims, i64, i64, p]
        lib.trs_cin_forward.restype = i
        lib.trs_cin_backward.argtypes = [p, p, p, p, p, p, p, p, *dims, i64, i64, p]
        lib.trs_cin_backward.restype = i
        lib._trs_typed = True
    return lib


def _dims(x0: torch.Tensor, xk: torch.Tensor, weight: torch.Tensor):
    b, n, e = x0.shape
    return b, n, e, xk.shape[1], weight.shape[0]


def _check(x0: torch.Tensor, xk: torch.Tensor, weight: torch.Tensor, **same_as_out) -> str:
    """Shapes, dtypes and devices: ``x0`` ``(B, N, E)``, ``xk`` ``(B, H, E)``,
    ``weight`` ``(O, H, N)``, each ``same_as_out`` ``(B, O, E)``, all of one
    dtype; returns the device kind ("cpu" or "cuda")."""
    _k.require(x0.dim() == 3 and xk.dim() == 3 and weight.dim() == 3,
               "x0, xk and weight must be 3-d: (B, N, E), (B, H, E), (O, H, N)")
    b, n, e = x0.shape
    o, h = weight.shape[:2]
    _k.require(xk.shape[0] == b and xk.shape[2] == e,
               f"xk {tuple(xk.shape)} does not match x0 {tuple(x0.shape)}")
    _k.require(weight.shape[1:] == (xk.shape[1], n),
               f"weight {tuple(weight.shape)} must be (O, H={xk.shape[1]}, N={n})")
    for name, t in same_as_out.items():
        _k.require(t.shape == (b, o, e), f"{name} must be {(b, o, e)}, got {tuple(t.shape)}")
    given = (x0, xk, weight, *same_as_out.values())
    kind = _k.device_kind(*given)
    dtypes = {t.dtype for t in given}
    _k.require(len(dtypes) == 1, f"the tensors must share one dtype, got {dtypes}")
    dtype = dtypes.pop()
    if kind == "cpu":
        _k.require(dtype in CPU_DTYPES, f"the CIN computes in float32 (float64 on the CPU), "
                                        f"got {dtype}")
    else:
        _k.require(dtype == torch.float32, f"the CIN's kernels take float32, got {dtype}")
        _k.require(x0.is_contiguous() and weight.is_contiguous()
                   and all(t.is_contiguous() for t in same_as_out.values()),
                   "x0, weight and the gradient must be contiguous")
        _k.require(xk.shape[2] <= 1 or xk.stride(2) == 1, "xk must be packed along E")
    return kind


def cin_forward_plain(x0: torch.Tensor, xk: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Plain version: the outer product ``z[h*N + n, b, e] = xk[b, h, e] *
    x0[b, n, e]`` formed explicitly and compressed by one product
    ``W.reshape(O, H*N) @ z.reshape(H*N, B*E)``, the JAX package's
    three-operand einsum in a contraction order that is fixed; the result is a
    ``(B, O, E)`` view of the ``(O, B, E)`` product."""
    b, h, e = xk.shape
    n = x0.shape[1]
    o = weight.shape[0]
    z = xk.permute(1, 0, 2)[:, None] * x0.permute(1, 0, 2)[None]  # (H, N, B, E)
    out = torch.matmul(weight.reshape(o, h * n), z.reshape(h * n, b * e))
    return out.reshape(o, b, e).permute(1, 0, 2)


def cin_forward(x0: torch.Tensor, xk: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """One CIN compression: ``(B, N, E)`` base, ``(B, H, E)`` previous map
    and ``(O, H, N)`` weight → ``(B, O, E)``.  On the card
    ``cin_forward_kernel`` writes a packed ``(B, O, E)`` tensor, after
    ``cin_transpose_kernel`` has written W^T; ``xk`` may be strided along B
    and H (the split-half CIN's second half of a map)."""
    if _check(x0, xk, weight) == "cpu":
        return cin_forward_plain(x0, xk, weight)
    b, n, e, h, o = _dims(x0, xk, weight)
    out = torch.empty(b, o, e, dtype=x0.dtype, device=x0.device)
    if not (out.numel() and weight.numel()):
        return out.zero_()
    _forward_launch(x0, xk, weight, out)
    cin_forward.launches += 1
    return out


cin_forward.launches = 0


def _forward_launch(x0, xk, weight, out) -> None:
    """The kernels' launches on the wrapper's tensors: W^T into a scratch
    that the forward kernel reads in 16-byte pieces, then the forward."""
    dims = _dims(x0, xk, weight)
    scratch = _scratch(0, dims, x0.device)
    status = _lib().trs_cin_forward(_k.ptr(x0), _k.ptr(xk), _k.ptr(weight), _k.ptr(scratch),
                                    _k.ptr(out), *dims, xk.stride(0), xk.stride(1),
                                    _k.current_stream(x0.device))
    _k.check_status(status, "cin_forward")


def cin_backward_plain(grad: torch.Tensor, x0: torch.Tensor, xk: torch.Tensor,
                       weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: autograd's backward through :func:`cin_forward_plain`
    from ``grad``, recomputed: ``(dx0, dxk, dweight)``, the bits the
    composition's own backward gives."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x0, xk, weight)]
        out = cin_forward_plain(*leaves)
        return torch.autograd.grad(out, leaves, grad)


def cin_backward(grad: torch.Tensor, x0: torch.Tensor, xk: torch.Tensor,
                 weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The compression's backward: ``(dx0, dxk, dweight)`` from ``grad``, the
    ``(B, O, E)`` gradient of :func:`cin_forward`'s output, and its inputs.
    On the card ``cin_backward_input_kernel`` (``dz = W^T grad`` a row group
    at a time in registers, reduced against ``x0`` into ``dxk`` and against
    ``xk`` into ``dx0``), ``cin_transpose_kernel`` (G^T) and
    ``cin_backward_weight_kernel`` (``grad z^T`` over column splits, then
    ``cin_weight_grad_sum_kernel`` where there is more than one); ``dxk`` is
    packed ``(B, H, E)`` whatever ``xk``'s strides."""
    if _check(x0, xk, weight, grad=grad) == "cpu":
        return cin_backward_plain(grad, x0, xk, weight)
    b, n, e, h, o = _dims(x0, xk, weight)
    dx0 = torch.empty_like(x0)
    dxk = torch.empty(b, h, e, dtype=xk.dtype, device=xk.device)
    dweight = torch.empty_like(weight)
    if not (grad.numel() and weight.numel()):
        return dx0.zero_(), dxk.zero_(), dweight.zero_()
    _backward_launch(grad, x0, xk, weight, dx0, dxk, dweight)
    cin_backward.launches += 1
    return dx0, dxk, dweight


cin_backward.launches = 0


def _backward_launch(grad, x0, xk, weight, dx0, dxk, dweight) -> None:
    """The kernels' launches on the wrapper's tensors, with their scratch:
    G^T, and the weight gradient's float32 partials where its tiling splits
    the columns."""
    dims = _dims(x0, xk, weight)
    scratch = _scratch(1, dims, x0.device)
    status = _lib().trs_cin_backward(_k.ptr(grad), _k.ptr(x0), _k.ptr(xk), _k.ptr(weight),
                                     _k.ptr(dx0), _k.ptr(dxk), _k.ptr(dweight), _k.ptr(scratch),
                                     *dims, xk.stride(0), xk.stride(1),
                                     _k.current_stream(x0.device))
    _k.check_status(status, "cin_backward")


def _scratch(backward: int, dims, device) -> torch.Tensor:
    """The float32 scratch ``csrc/cin.cu`` sizes for a forward (0) or a
    backward (1) at ``dims`` (B, N, E, H, O)."""
    floats = _lib().trs_cin_scratch(backward, *dims)
    _k.require(floats >= 0, f"no tiling of the CIN's kernels fits the card at (B, N, E, H, O) "
                            f"= {dims} (CUDA error {-floats})")
    return torch.empty(floats, dtype=torch.float32, device=device)


__all__ = ["cin_backward", "cin_backward_plain", "cin_forward", "cin_forward_plain"]
