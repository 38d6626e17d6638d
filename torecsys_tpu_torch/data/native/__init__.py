"""Native (C++) host input components (counterpart of
``torecsys_tpu/data/native``): the id-stream presort and the Criteo DAC
parser.

:func:`presort_lib` and :func:`parser_lib` compile ``id_preprocess.cc`` and
``criteo_parser.cc`` with ``g++`` at first use, never at import, into
``build/native/`` at the root of the checkout (each library is named by a
hash of its source and the flags, so an edited source is rebuilt, and lands
by an atomic rename, so concurrent builds are safe), and load them with
``ctypes``, which releases the interpreter lock for the call.  Where no
compiler works they return None and log a warning; the caller then takes
the Python route: the numpy presort (``data.presort``), or
:func:`_parse_python` for the parser.  :func:`native_available` says
whether :func:`parse_criteo_tsv` takes the C++ route.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

NUM_DENSE = 13
NUM_CATS = 26

SOURCE = Path(__file__).resolve().parent / "id_preprocess.cc"
PARSER_SOURCE = Path(__file__).resolve().parent / "criteo_parser.cc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
PARSER_FLAGS = CXX_FLAGS + ("-pthread",)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False
_parser: Optional[ctypes.CDLL] = None
_parser_failed = False


def _library_path(source: Path, flags: Sequence[str], stem: str) -> Path:
    digest = hashlib.sha1(source.read_bytes() + repr(tuple(flags)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{stem}_{digest}.so"


def library_path() -> Path:
    """Where the presort library lands: named by a hash of its source and
    the compiler flags."""
    return _library_path(SOURCE, CXX_FLAGS, "id_preprocess")


def parser_library_path() -> Path:
    """Where the Criteo parser library lands, named as :func:`library_path`."""
    return _library_path(PARSER_SOURCE, PARSER_FLAGS, "criteo_parser")


def _build(source: Path, flags: Sequence[str], out: Path) -> Path:
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}.so")
        subprocess.run(["g++", *flags, str(source), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, out)  # atomic against a concurrent build
    return out


def _load(source: Path, flags: Sequence[str], out: Path, what: str, fallback: str
          ) -> Optional[ctypes.CDLL]:
    """Build (if needed) and load one library; None, with a warning, when
    either fails."""
    try:
        return ctypes.CDLL(str(_build(source, flags, out)))
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        logger.warning("native %s unavailable (%s %s); %s", what, e,
                       detail.decode(errors="replace")[-500:], fallback)
        return None


def presort_lib() -> Optional[ctypes.CDLL]:
    """The compiled presort (``trs_presort_ids``), built at first use; None
    when it cannot be built or loaded (a warning is logged once)."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        lib = _load(SOURCE, CXX_FLAGS, library_path(), "id presort", "presorting with numpy")
        if lib is None:
            _failed = True
            return None
        p = ctypes.POINTER(ctypes.c_int32)
        lib.trs_presort_ids.restype = ctypes.c_int32
        lib.trs_presort_ids.argtypes = [p, ctypes.c_int64, ctypes.c_int32, p, ctypes.c_int32,
                                        ctypes.c_int32, p, p, p, p]
        _lib = lib
        return _lib


def parser_lib() -> Optional[ctypes.CDLL]:
    """The compiled Criteo parser (``trs_parse_criteo``), built at first use;
    None when it cannot be built or loaded (a warning is logged once)."""
    global _parser, _parser_failed
    with _lock:
        if _parser is not None or _parser_failed:
            return _parser
        lib = _load(PARSER_SOURCE, PARSER_FLAGS, parser_library_path(), "Criteo parser",
                    "parsing in Python")
        if lib is None:
            _parser_failed = True
            return None
        lib.trs_parse_criteo.restype = ctypes.c_int64
        lib.trs_parse_criteo.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
        ]
        _parser = lib
        return _parser


def native_available() -> bool:
    """True when the C++ Criteo parser builds and loads."""
    return parser_lib() is not None


def _fnv1a(token: bytes) -> int:
    """FNV-1a 32-bit, as ``fnv1a`` in ``criteo_parser.cc``."""
    h = 2166136261
    for b in token:
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


def _parse_dense_token(tok: bytes) -> int:
    """The dense-token grammar of both routes: ``[+-]?[0-9]+``, anything
    else (empty included) is missing → 0."""
    digits = tok[1:] if tok[:1] in (b"+", b"-") else tok
    if not digits or not digits.isdigit():
        return 0
    return int(tok)


_log1pf_fn = None


def _log1pf(v: int) -> float:
    """libm's ``log1pf``, the function the C++ route calls.  numpy's float32
    ``log1p`` differs from it in the last bit for about 4% of the integers
    below 2.6M on one x86 host (glibc against numpy's own code), so the
    Python route calls the same libm function, and both routes give the
    same bits on any one machine."""
    global _log1pf_fn
    if _log1pf_fn is None:
        fn = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6").log1pf
        fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
        _log1pf_fn = fn
    return _log1pf_fn(v)


def _parse_python(data: bytes, max_rows: int, hash_sizes: np.ndarray):
    """The Python route, line for line the C++ one: every ``\\n``-delimited
    segment is one row (a malformed one gives an all-zero row), and a last
    segment without a newline still counts."""
    segments = data.split(b"\n")
    if segments and segments[-1] == b"":
        segments.pop()
    segments = segments[:max_rows]
    rows = len(segments)
    labels = np.zeros((max_rows,), np.float32)
    dense = np.zeros((max_rows, NUM_DENSE), np.float32)
    cats = np.zeros((max_rows, NUM_CATS), np.int32)
    for r, line in enumerate(segments):
        parts = line.rstrip(b"\r").split(b"\t")
        if len(parts) != 1 + NUM_DENSE + NUM_CATS:
            continue
        labels[r] = 1.0 if parts[0][:1] == b"1" else 0.0
        for f in range(NUM_DENSE):
            v = _parse_dense_token(parts[1 + f])
            dense[r, f] = _log1pf(v) if v > 0 else 0.0
        for f in range(NUM_CATS):
            tok = parts[1 + NUM_DENSE + f]
            cats[r, f] = _fnv1a(tok) % int(hash_sizes[f]) if tok else 0
    return rows, labels, dense, cats


def parse_criteo_tsv(data: bytes, hash_sizes: Sequence[int], max_rows: Optional[int] = None,
                     num_threads: int = 0, force_python: bool = False) -> Dict[str, np.ndarray]:
    """Parse Criteo DAC TSV bytes into fixed-shape column arrays.

    Args:
        data: raw file bytes (tab-separated, one example per line).
        hash_sizes: each categorical field's modulus (26 entries, all > 0).
        max_rows: cap on parsed rows (default: all lines).
        num_threads: C++ parse threads; 0 = ``os.cpu_count()``.
        force_python: take the Python route (:func:`_parse_python`).

    Returns:
        ``{"label": (R,) float32, "dense": (R, 13) float32 (log1p),
        "cats": (R, 26) int32 (FNV-1a hashed)}``.
    """
    hs = np.asarray(list(hash_sizes), dtype=np.int64)
    if hs.shape != (NUM_CATS,):
        raise ValueError(f"hash_sizes must have {NUM_CATS} entries, got {hs.shape}")
    if not (hs > 0).all():
        # zero divides by zero in the C++ modulo; a negative size gives ids
        # out of range through the uint64 cast
        raise ValueError(f"hash_sizes must all be positive, got {hs.tolist()}")
    if max_rows is None:
        max_rows = data.count(b"\n") + (0 if data.endswith(b"\n") else 1)
    max_rows = max(0, max_rows)
    if max_rows == 0:
        return {"label": np.zeros((0,), np.float32),
                "dense": np.zeros((0, NUM_DENSE), np.float32),
                "cats": np.zeros((0, NUM_CATS), np.int32)}
    lib = None if force_python else parser_lib()
    if lib is None:
        rows, labels, dense, cats = _parse_python(data, max_rows, hs)
    else:
        labels = np.zeros((max_rows,), np.float32)
        dense = np.zeros((max_rows, NUM_DENSE), np.float32)
        cats = np.zeros((max_rows, NUM_CATS), np.int32)
        rows = lib.trs_parse_criteo(
            data, len(data), max_rows,
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            dense.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            cats.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            hs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            num_threads or (os.cpu_count() or 1),
        )
    return {"label": labels[:rows], "dense": dense[:rows], "cats": cats[:rows]}


__all__ = ["BUILD_DIR", "CXX_FLAGS", "NUM_CATS", "NUM_DENSE", "PARSER_FLAGS", "PARSER_SOURCE",
           "SOURCE", "library_path", "native_available", "parse_criteo_tsv",
           "parser_library_path", "parser_lib", "presort_lib"]
