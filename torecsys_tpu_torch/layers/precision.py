"""Mixed precision: the dense towers' compute dtype and the embedding tables'
storage dtype (counterpart of ``torecsys_tpu/layers/precision.py``).

The JAX package reads both from a thread-local context while it traces.
torch has no trace time, so here each is an attribute of the modules it
concerns, set by the pipeline (``Pipeline.set_compute_dtype`` and
``set_table_dtype``, applied at ``finalize``):

* ``compute_dtype`` on each :class:`~torecsys_tpu_torch.layers.ctr.dense.Dense`
  (the JAX package's ``Dense`` sites: the MLP towers, the Wide layer, LR,
  AFM's attention, the CIN's and DCN's heads): under bf16 each product
  casts the input and weight to bf16 and rounds to bf16
  (``torch.nn.functional.linear``, cuBLAS on the card), then the bf16 bias
  is added in bf16, as flax ``Dense(dtype=bf16, param_dtype=f32)`` does;
  every other layer computes in float32, as in the JAX package; the
  parameters stay float32 and ``Sequential`` casts each bf16 leaf of a
  model's output (a tensor, or a tuple, list or dict of them) to float32;
* ``compute_dtype`` on each
  :class:`~torecsys_tpu_torch.layers.ctr.attention.MultiHeadDotProductAttention`
  (the JAX package's ``mha_dtype()``, flax's ``dtype=``): under bf16 the
  query, key, value and out projections, the scores and their softmax run
  in bf16;
* a module built with ``follows_pipeline=False`` keeps float32: the JAX
  package's plain flax sites, built without ``dtype=`` (a
  ``ListIndicesEmbedding``'s attention, a ``SequenceIndicesEmbedding``'s
  ``bidir_proj``); the recurrent cells (``layers.rnn``) have no compute
  dtype and compute in float32, as flax's cells promote to their float32
  kernels;
* the table dtype of each table module (:class:`~torecsys_tpu_torch.inputs.embeddings.TableInput`):
  its table is stored in it, and its looked-up rows are cast to float32 at
  the module boundary.  A bf16 table is a dense-route feature, as in the JAX
  package.

:func:`use_torch_linear_init` is the JAX package's context of the same name:
inside it each pipeline-following ``Dense`` (the JAX package's precision
``Dense`` sites) draws its parameters as ``torch.nn.Linear`` does.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Union

import torch
from torch import nn

DtypeLike = Union[str, torch.dtype, None]


def resolve_dtype(dtype: DtypeLike) -> Optional[torch.dtype]:
    """``None``, ``"float32"`` or ``"f32"`` → None (full float32);
    ``"bfloat16"`` (or ``torch.bfloat16``) → ``torch.bfloat16``."""
    if dtype is None or dtype in ("float32", "f32", torch.float32):
        return None
    if dtype in ("bfloat16", "bf16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"unsupported dtype {dtype!r}: use 'bfloat16' or 'float32'/None")


def is_reduced(dtype: DtypeLike) -> bool:
    """True for a dtype narrower than float32."""
    return resolve_dtype(dtype) is not None


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax`` as XLA computes it under ``jit``, in ``x``'s
    dtype: ``e = exp(x - max)`` in float32, the numerator ``e`` rounded to
    ``x``'s dtype, the denominator the float32 sum of the unrounded ``e``
    rounded to it, and their quotient in it.  In float32 this is the plain
    softmax; in bf16 ``torch.softmax`` (one rounding at the end) would take
    other bits."""
    shifted = x - x.amax(dim=dim, keepdim=True)
    e = torch.exp(shifted.float())
    return e.to(x.dtype) / e.sum(dim=dim, keepdim=True).to(x.dtype)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA computes it under ``jit`` on the CPU, in
    ``x``'s dtype: in float32 the plain sigmoid; in bf16 ``1 / (1 +
    exp(-x))`` with each operation rounded to bf16 (``torch.sigmoid`` rounds
    once at the end and differs by an ulp on about a third of the inputs)."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def apply_compute_dtype(module: nn.Module, dtype: DtypeLike) -> None:
    """Set the compute dtype of every module under ``module`` that has one
    and follows the pipeline's."""
    resolved = resolve_dtype(dtype)
    for m in module.modules():
        if hasattr(m, "compute_dtype") and getattr(m, "follows_pipeline", True):
            m.compute_dtype = resolved


def apply_table_dtype(module: nn.Module, dtype: DtypeLike) -> None:
    """Store every embedding table under ``module`` in ``dtype``."""
    resolved = resolve_dtype(dtype) or torch.float32
    for m in module.modules():
        if hasattr(m, "set_table_dtype"):
            m.set_table_dtype(resolved)


_state = threading.local()


@contextlib.contextmanager
def use_torch_linear_init():
    """Init-time context: each :class:`~torecsys_tpu_torch.layers.ctr.dense.Dense`
    that follows the pipeline's compute dtype and draws its parameters inside
    it (at construction or ``reset_parameters``, which the Trainer calls
    when it seeds the model) draws them as ``torch.nn.Linear`` does, weight
    and bias ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``, instead of flax's
    lecun-normal weight and zero bias.  Names and shapes stay the same, so
    ``convert`` and checkpoints interoperate; the bits differ from the JAX
    package's (another generator)."""
    prev = getattr(_state, "torch_init", False)
    _state.torch_init = True
    try:
        yield
    finally:
        _state.torch_init = prev


def torch_linear_init() -> bool:
    """True inside :func:`use_torch_linear_init`."""
    return getattr(_state, "torch_init", False)


def __getattr__(name: str):
    # ``Dense`` lives in ``layers.ctr.dense``, which imports this module
    if name == "Dense":
        from torecsys_tpu_torch.layers.ctr.dense import Dense

        return Dense
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Dense", "apply_compute_dtype", "apply_table_dtype", "is_reduced", "resolve_dtype",
           "sigmoid", "softmax", "torch_linear_init", "use_torch_linear_init"]
