"""The check that no JAX and no JAX package was loaded.

The port's package name begins with the JAX package's (``torecsys_tpu_torch``
and ``torecsys_tpu``), so modules are compared by their top-level name, the
part before the first dot, as a whole word.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "torecsys_tpu")


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: the
    process's ``sys.modules``), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


__all__ = ["FORBIDDEN", "forbidden_loaded"]
