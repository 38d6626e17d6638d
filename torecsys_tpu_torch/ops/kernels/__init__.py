"""Hand-written Hopper kernels and their build.

Each kernel module here holds a wrapper that checks its tensors and launches
the CUDA kernel for tensors on the card, the plain PyTorch version of the
same function (taken for tensors on the CPU), and a launch counter.

The CUDA sources live in ``torecsys_tpu_torch/csrc/``.  :func:`load_library`
compiles one with ``nvcc`` for ``sm_90a`` into a shared library with a plain
C interface under ``build/torch_kernels/`` at first use, and loads it with
``ctypes``; nothing is compiled when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the card's host")


def library_path(source: str, defines: Tuple[str, ...] = ()) -> Path:
    """Where the library of ``csrc/<source>`` built with the macros
    ``defines`` lands: named by a hash of the source, macros and flags, so an
    edited source is rebuilt."""
    src = CSRC / source
    key = src.read_bytes() + repr((NVCC_FLAGS, defines)).encode()
    digest = hashlib.sha1(key).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build(source: str, defines: Tuple[str, ...] = ()) -> Tuple[Path, str]:
    """Compile ``csrc/<source>`` with the macros ``defines`` (``-D``) if its
    library is missing; returns the library path and the compiler's output
    (ptxas register/spill report)."""
    out = library_path(source, defines)
    if out.exists():
        return out, build_logs.get(out.name, "")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp),
           str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    build_logs[out.name] = proc.stdout + proc.stderr
    return out, build_logs[out.name]


def load_library(source: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<source>`` with ``defines``."""
    with _lock:
        lib = _libs.get((source, defines))
        if lib is None:
            path, _ = build(source, defines)
            lib = ctypes.CDLL(str(path))
            _libs[(source, defines)] = lib
        return lib


def current_stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_status(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {status}")


def require(cond: bool, msg: str) -> None:
    """A wrapper's check of its tensors: raises ``ValueError(msg)``."""
    if not cond:
        raise ValueError(msg)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def device_kind(*tensors: torch.Tensor) -> str:
    """'cpu' or 'cuda' when every tensor lies there; raises on a mix."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return "cuda"
    raise ValueError(f"tensors must all lie on the CPU or all on one CUDA device, got {kinds}")


__all__ = ["BUILD_DIR", "CSRC", "build", "build_logs", "check_status",
           "current_stream", "device_kind", "library_path", "load_library", "ptr",
           "require"]
