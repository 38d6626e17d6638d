"""Native (C++) host input components (counterpart of
``torecsys_tpu/data/native``): the id-stream presort.

:func:`presort_lib` compiles ``id_preprocess.cc`` with ``g++`` at first use,
never at import, into ``build/native/`` at the root of the checkout (the
library is named by a hash of the source and the flags, so an edited source
is rebuilt, and lands by an atomic rename, so concurrent builds are safe),
and loads it with ``ctypes``, which releases the interpreter lock for the
call.  Where no compiler works it returns None and logs a warning; the
caller then presorts with numpy (``data.presort``).

The Criteo parser (``criteo_parser.cc``) is not ported yet.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "id_preprocess.cc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def library_path() -> Path:
    """Where the presort library lands: named by a hash of its source and
    the compiler flags."""
    digest = hashlib.sha1(SOURCE.read_bytes() + repr(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libid_preprocess_{digest}.so"


def _build() -> Path:
    out = library_path()
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}.so")
        subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, out)  # atomic against a concurrent build
    return out


def presort_lib() -> Optional[ctypes.CDLL]:
    """The compiled presort (``trs_presort_ids``), built at first use; None
    when it cannot be built or loaded (a warning is logged once)."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            logger.warning("native id presort unavailable (%s %s); presorting with numpy",
                           e, detail.decode(errors="replace")[-500:])
            _failed = True
            return None
        p = ctypes.POINTER(ctypes.c_int32)
        lib.trs_presort_ids.restype = ctypes.c_int32
        lib.trs_presort_ids.argtypes = [p, ctypes.c_int64, ctypes.c_int32, p, ctypes.c_int32,
                                        ctypes.c_int32, p, p, p, p]
        _lib = lib
        return _lib


__all__ = ["BUILD_DIR", "CXX_FLAGS", "SOURCE", "library_path", "presort_lib"]
