"""Status decorators (counterpart of ``torecsys_tpu/utils/decorator.py``):

* :func:`in_development` — a ``FutureWarning`` when a class is built or a
  function called: its API or behaviour may change (DSIN carries it);
* :func:`deprecated` — a ``DeprecationWarning`` naming the replacement;
* :func:`not_jittable` — refuses a host-side helper's call while the
  current CUDA stream captures a graph, the torch meaning of the JAX
  marker's refusal under a ``jax.jit`` trace: a capture, like a trace,
  would freeze one snapshot of the helper's Python side effects into what
  is replayed.
"""

from __future__ import annotations

import functools
import warnings

import torch


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


def not_jittable(fn):
    """Raise if ``fn`` is called while the current CUDA stream captures a
    graph (``torch.cuda.is_current_stream_capturing()``), before ``fn``
    runs, so nothing of it is enqueued into the capture.

    For host-side helpers with Python side effects (vocabulary growth, file
    IO): calling them during a capture would silently freeze one snapshot of
    the side-effected state into the replayed graph.
    """

    @functools.wraps(fn)
    def wrapper(*a, **k):
        if torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{fn.__name__} is host-side only (mutates Python state) and "
                "was called inside a CUDA graph capture; call it before capturing."
            )
        return fn(*a, **k)

    return wrapper


__all__ = ["deprecated", "in_development", "not_jittable"]
