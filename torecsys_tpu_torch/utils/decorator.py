"""Status decorators (counterpart of ``torecsys_tpu/utils/decorator.py``):

* :func:`in_development` — a ``FutureWarning`` when a class is built or a
  function called: its API or behaviour may change (DSIN carries it);
* :func:`deprecated` — a ``DeprecationWarning`` naming the replacement.

The JAX package's third marker, ``not_jittable``, refuses a call inside a
``jax.jit`` trace; its torch meaning is not ported.
"""

from __future__ import annotations

import functools
import warnings


def in_development(reason: str = ""):
    """Mark a class or function as in development: each construction (or
    call) warns a ``FutureWarning``."""

    def deco(obj):
        msg = (f"{getattr(obj, '__name__', obj)!s} is in development; its "
               f"API/behavior may change. {reason}".strip())
        if isinstance(obj, type):
            orig_init = obj.__init__

            @functools.wraps(orig_init)
            def __init__(self, *a, **k):
                warnings.warn(msg, FutureWarning, stacklevel=2)
                orig_init(self, *a, **k)

            obj.__init__ = __init__
            return obj

        @functools.wraps(obj)
        def wrapper(*a, **k):
            warnings.warn(msg, FutureWarning, stacklevel=2)
            return obj(*a, **k)

        return wrapper

    return deco


def deprecated(replacement: str = ""):
    """Mark a callable as deprecated: each call warns a
    ``DeprecationWarning`` pointing at ``replacement``."""

    def deco(obj):
        msg = (f"{getattr(obj, '__name__', obj)!s} is deprecated"
               + (f"; use {replacement} instead" if replacement else "")
               + ".")

        @functools.wraps(obj)
        def wrapper(*a, **k):
            warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return obj(*a, **k)

        return wrapper

    return deco


__all__ = ["deprecated", "in_development"]
