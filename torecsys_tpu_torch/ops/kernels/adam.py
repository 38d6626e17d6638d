"""The dense optimizer's Adam and AdamW update: every tensor of a parameter
group in one pass.

Written in CUDA C++ in ``csrc/adam.cu``, whose header says why it exists (no
TPU kernel is its counterpart: XLA fuses optax's chain by itself) and what
bounds it on the card.  :func:`adam_update` updates a group's parameters,
first moments, second moments and float32 step counts in place: on the card
through the kernel, a count launch and an update launch for each table of up
to :data:`MAX_TENSORS` tensors (:func:`plan_launches`); for tensors on the CPU
through :func:`adam_update_plain`, torch's capturable single-tensor step
written out one operation at a time, which is the kernel's specification.
It raises on anything else: a mix of devices, a dtype other than float32, a
shape or layout the kernel does not take.  ``launches`` on the wrapper counts
the update launches (each with its count launch) and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from torecsys_tpu_torch.ops import kernels as _k

SOURCE = "adam.cu"
MAX_TENSORS = 64      # tensors a launch (csrc kMaxTensors)
THREADS = 256         # threads a block of the update (csrc kThreads)
UNIT = 4              # elements a unit: one 16-byte vector of float32 (csrc kUnit)
VECTOR_BYTES = 16
BLOCKS_PER_SM = 2048 // THREADS  # a full SM's threads: the grid-stride loop's grid

_PTRS = ctypes.c_void_p * MAX_TENSORS


class AdamTable(ctypes.Structure):
    """One launch's arguments, as ``AdamTable`` in ``csrc/adam.cu``: passed to
    the kernels by value."""

    _fields_ = [
        ("p", _PTRS), ("g", _PTRS), ("m", _PTRS), ("v", _PTRS), ("step", _PTRS),
        ("numel", ctypes.c_longlong * MAX_TENSORS),
        ("start", ctypes.c_longlong * (MAX_TENSORS + 1)),
        ("vec", ctypes.c_ubyte * MAX_TENSORS),
        ("n", ctypes.c_int),
        ("lr", ctypes.c_float), ("b1", ctypes.c_float), ("b2", ctypes.c_float),
        ("eps", ctypes.c_float), ("w1", ctypes.c_float), ("c2", ctypes.c_float),
        ("decay", ctypes.c_float), ("wd", ctypes.c_float),
    ]


def _lib():
    lib = _k.load_library(SOURCE)
    if not getattr(lib, "_trs_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.trs_multi_tensor_adam.argtypes = [p, i, p]
        lib.trs_multi_tensor_adam.restype = i
        for name in ("trs_adam_max_tensors", "trs_adam_table_bytes", "trs_adam_threads"):
            getattr(lib, name).restype = i
        built = (lib.trs_adam_max_tensors(), lib.trs_adam_table_bytes(), lib.trs_adam_threads())
        want = (MAX_TENSORS, ctypes.sizeof(AdamTable), THREADS)
        if built != want:
            raise RuntimeError(f"{SOURCE} lays out its table as (tensors, bytes, threads) "
                               f"{built}, the wrapper as {want}")
        lib._trs_typed = True
    return lib


# One tensor of a launch: addresses of p, g (0: no gradient), m, v and the
# step count, and p's element count.
Entry = Tuple[int, int, int, int, int, int]


def vector_path(entry: Entry) -> bool:
    """Whether a tensor's whole units move as 16-byte vectors: p, g, m and v
    all start on a 16-byte boundary (a tensor without a gradient reads no g).
    A unit past the last whole one takes the scalar path either way."""
    p, g, m, v = entry[:4]
    return all(a % VECTOR_BYTES == 0 for a in (p, m, v) + ((g,) if g else ()))


def hyper_fields(lr: float, b1: float, b2: float, eps: float, weight_decay: float,
                 decoupled: bool) -> dict:
    """The table's scalars: each rounded to float32 from the double that torch's
    step computes on the host (``1 - b1``, ``1 - b2``, AdamW's ``1 - lr * wd``)."""
    decay = 1.0 - lr * weight_decay if decoupled and weight_decay != 0 else 1.0
    return dict(lr=lr, b1=b1, b2=b2, eps=eps, w1=1.0 - b1, c2=1.0 - b2, decay=decay,
                wd=0.0 if decoupled else weight_decay)


def plan_launches(entries: Sequence[Entry], hyper: dict, sms: int) -> List[Tuple[AdamTable, int]]:
    """Pack the tensors into tables of up to MAX_TENSORS, in order, each with
    the update's grid: ``[(table, blocks)]``.  A tensor takes
    ``ceil(numel / UNIT)`` units (none if empty: its count still advances);
    ``start`` holds each tensor's first unit; the grid covers every unit once
    up to BLOCKS_PER_SM blocks an SM, past which the threads loop."""
    plans = []
    for lo in range(0, len(entries), MAX_TENSORS):
        chunk = entries[lo:lo + MAX_TENSORS]
        table = AdamTable(n=len(chunk), **hyper)
        units = 0
        for i, entry in enumerate(chunk):
            p, g, m, v, step, numel = entry
            table.p[i], table.g[i], table.m[i], table.v[i], table.step[i] = p, g or None, m, v, step
            table.numel[i], table.start[i] = numel, units
            table.vec[i] = vector_path(entry)
            units += -(-numel // UNIT)
        table.start[len(chunk)] = units
        blocks = max(1, min(-(-units // THREADS), sms * BLOCKS_PER_SM))
        plans.append((table, blocks))
    return plans


def adam_update_plain(params: Sequence[torch.Tensor], grads: Sequence[Optional[torch.Tensor]],
                      exp_avgs: Sequence[torch.Tensor], exp_avg_sqs: Sequence[torch.Tensor],
                      steps: Sequence[torch.Tensor], *, lr: float, b1: float, b2: float,
                      eps: float, weight_decay: float = 0.0, decoupled: bool = False) -> None:
    """Plain version: torch's capturable single-tensor Adam step
    (``torch.optim.adam._single_tensor_adam``), one tensor and one operation
    at a time; a missing gradient is zeros."""
    for p, g, m, v, step in zip(params, grads, exp_avgs, exp_avg_sqs, steps):
        g = torch.zeros_like(p) if g is None else g
        step += 1
        if weight_decay != 0:
            if decoupled:
                p.mul_(1 - lr * weight_decay)
            else:
                g = g.add(p, alpha=weight_decay)
        m.lerp_(g, 1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        neg = (lr / (1 - b1 ** step)).neg()
        denom = (v.sqrt() / ((1 - b2 ** step).sqrt() * neg)).add_(eps / neg)
        p.addcdiv_(m, denom)


def adam_update(params: Sequence[torch.Tensor], grads: Sequence[Optional[torch.Tensor]],
                exp_avgs: Sequence[torch.Tensor], exp_avg_sqs: Sequence[torch.Tensor],
                steps: Sequence[torch.Tensor], *, lr: float, b1: float, b2: float, eps: float,
                weight_decay: float = 0.0, decoupled: bool = False) -> None:
    """One Adam step over a group, in place.

    Args:
        params: the parameters, contiguous float32.
        grads: each parameter's gradient, of its shape and layout, or None
            (updated as a zero gradient; nothing is allocated on the card).
        exp_avgs, exp_avg_sqs: the first and second moments, of each
            parameter's shape and layout.
        steps: each parameter's step count, a one-element float32 tensor,
            advanced by one before the update reads it.
        lr, b1, b2, eps: floats.
        weight_decay: AdamW's decoupled decay (``decoupled``), else Adam's L2
            term added to the gradient.
    """
    n = len(params)
    _k.require(all(len(x) == n for x in (grads, exp_avgs, exp_avg_sqs, steps)),
               "params, grads, exp_avgs, exp_avg_sqs and steps must have one entry each")
    _k.require(all(isinstance(x, (int, float)) for x in (lr, b1, b2, eps, weight_decay)),
               "lr, b1, b2, eps and weight_decay must be numbers")
    tensors = []
    for p, g, m, v, step in zip(params, grads, exp_avgs, exp_avg_sqs, steps):
        for name, t in (("param", p), ("grad", g), ("exp_avg", m), ("exp_avg_sq", v)):
            if t is None and name == "grad":
                continue
            if not (t.dtype == torch.float32 and t.layout == torch.strided
                    and t.is_contiguous() and t.shape == p.shape):
                raise ValueError(f"{name} must be a contiguous float32 tensor of its parameter's "
                                 f"shape {tuple(p.shape)}, got {t.dtype} {tuple(t.shape)} "
                                 f"{t.layout} contiguous={t.is_contiguous()}")
            tensors.append(t)
        _k.require(step.dtype == torch.float32 and step.numel() == 1,
                   "step must be one float32 element")
        tensors.append(step)
    if n == 0:
        return
    hyper = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, decoupled=decoupled)
    if _k.device_kind(*tensors) == "cpu":
        adam_update_plain(params, grads, exp_avgs, exp_avg_sqs, steps, **hyper)
        return
    entries = [(p.data_ptr(), 0 if g is None else g.data_ptr(), m.data_ptr(), v.data_ptr(),
                step.data_ptr(), p.numel())
               for p, g, m, v, step in zip(params, grads, exp_avgs, exp_avg_sqs, steps)]
    device = params[0].device
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    fn, stream = _lib().trs_multi_tensor_adam, _k.current_stream(device)
    for table, blocks in plan_launches(entries, hyper_fields(**hyper), sms):
        _k.check_status(fn(ctypes.byref(table), blocks, stream), "multi_tensor_adam")
        adam_update.launches += 1


adam_update.launches = 0


__all__ = ["AdamTable", "MAX_TENSORS", "adam_update", "adam_update_plain", "hyper_fields",
           "plan_launches", "vector_path"]
