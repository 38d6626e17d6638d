"""The tracer's stamp kernel (``utils.trace``): a clock written into a slot.

Written in CUDA C++ in ``csrc/trace.cu``, whose header says why it exists
(no TPU kernel is its counterpart).  :func:`stamp` writes the card's
``%globaltimer`` into one int64 slot of a buffer on the card, in stream
order, and is captured into a CUDA graph like any launch; for a buffer on
the CPU it writes the host's ``time.perf_counter_ns()`` (:func:`stamp_plain`),
so the tracer runs the same code in the CPU tests.  ``launches`` counts its
kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import time
from typing import List, Tuple

import torch

from torecsys_tpu_torch.ops import kernels as _k

SOURCE = "trace.cu"


def _lib():
    lib = _k.load_library(SOURCE)
    if not getattr(lib, "_trs_typed", False):
        lib.trs_trace_stamp.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.trs_trace_stamp.restype = ctypes.c_int
        lib._trs_typed = True
    return lib


def stamp_plain(buf: torch.Tensor, index: int) -> None:
    """Plain version: the host's ``perf_counter_ns`` into ``buf``'s flat
    element ``index``."""
    buf.view(-1)[index] = time.perf_counter_ns()


def stamp(buf: torch.Tensor, index: int) -> None:
    """Write the clock, in ns, into the flat element ``index`` of the
    contiguous int64 ``buf``: on the card its ``%globaltimer`` when the
    current stream reaches the launch; on the CPU the host's
    ``perf_counter_ns`` now."""
    _k.require(buf.dtype == torch.int64 and buf.is_contiguous(),
               f"buf must be contiguous int64, got {buf.dtype}")
    _k.require(0 <= index < buf.numel(), f"index {index} outside buf of {buf.numel()}")
    if _k.device_kind(buf) == "cpu":
        stamp_plain(buf, index)
        return
    status = _lib().trs_trace_stamp(ctypes.c_void_p(buf.data_ptr() + 8 * index),
                                    _k.current_stream(buf.device))
    _k.check_status(status, "trace_stamp")
    stamp.launches += 1


stamp.launches = 0


def bracketed(buf: torch.Tensor) -> List[Tuple[int, int]]:
    """Stamp each element of the int64 card buffer ``buf`` in turn, each
    between two readings of the host's ``perf_counter_ns``: the first after
    the card is idle and just before the launch, the second as soon as a
    poll of the stream finds the stamp done.  The card's stamp ``i`` lies
    between the readings of pair ``i`` (the clock's calibration,
    ``utils.trace``)."""
    _k.require(buf.dtype == torch.int64 and buf.dim() == 1 and buf.is_cuda,
               f"buf must be (n,) int64 on the card, got {tuple(buf.shape)} {buf.dtype} "
               f"on {buf.device}")
    fn, stream = _lib().trs_trace_stamp, torch.cuda.current_stream(buf.device)
    handle, clock = ctypes.c_void_p(stream.cuda_stream), time.perf_counter_ns
    pairs = []
    for i in range(buf.numel()):
        slot = ctypes.c_void_p(buf.data_ptr() + 8 * i)
        torch.cuda.synchronize(buf.device)
        h0 = clock()
        status = fn(slot, handle)
        while not stream.query():
            pass
        pairs.append((h0, clock()))
        _k.check_status(status, "trace_stamp")
        stamp.launches += 1
    return pairs


__all__ = ["bracketed", "stamp", "stamp_plain"]
