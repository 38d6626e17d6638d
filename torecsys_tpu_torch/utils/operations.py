"""Tensor operations (counterpart of ``torecsys_tpu/utils/operations.py``):
the pair counts and indices, the attention stand-in, the StarSpace
similarity, the regularizer's penalty, ``replicate_tensor``, the attention
heat-map and the capsules' ``squash``."""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Callable, Collection, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from torecsys_tpu_torch.convert import flax_path, flax_paths


def combination(n: int, r: int) -> int:
    """Number of r-combinations of n items (nCr)."""
    return math.comb(n, r)


@lru_cache(maxsize=None)
def pair_indices(num_fields: int, offset: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Row and column indices of every pair ``(i, j)`` with ``j >= i +
    offset``, in row-major order, as int32 numpy arrays (C(num_fields, 2)
    pairs for ``offset=1``)."""
    rows, cols = [], []
    for i in range(num_fields):
        for j in range(i + offset, num_fields):
            rows.append(i)
            cols.append(j)
    return np.asarray(rows, dtype=np.int32), np.asarray(cols, dtype=np.int32)


def dummy_attention(key: torch.Tensor, query: torch.Tensor, value: torch.Tensor):
    """Identity stand-in with an attention call's signature: ``(value, zeros
    (B, L, L))`` in ``value``'s dtype."""
    b, l = value.shape[0], value.shape[1]
    return value, value.new_zeros((b, l, l))


def inner_product_similarity(a: torch.Tensor, b: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Sum of elementwise products over ``dim`` (the StarSpace similarity)."""
    return torch.sum(a * b, dim=dim)


def regularize(params: Union[nn.Module, Mapping[str, torch.Tensor]], weight_decay: float = 0.01,
               norm: int = 2, key_filter: str = "kernel",
               group_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
               sharded: Collection[str] = ()):
    """Differentiable penalty ``weight_decay * Σ |p|^norm`` (no root taken)
    over the parameters whose flax path contains ``key_filter``.

    ``params`` is a module (its named parameters) or ``{port name: tensor}``.
    A parameter is selected by the path the JAX package gives it
    (:func:`~torecsys_tpu_torch.convert.flax_paths` of a module,
    :func:`~torecsys_tpu_torch.convert.flax_path` of a name), not by its
    torch name: the port stores a flax ``kernel`` as a transposed
    ``weight``, so the default filter selects the same dense kernels and
    leaves out the tables (``embedding``), the biases and the FiBiNET
    bilinear weights, as in the JAX package.  Each term is taken in
    float32.

    ``sharded`` names row-sharded tables (a rank's rows of each): the term
    of each is the whole table's in value, ``group_sum`` (a sum over the
    table group, in place) of the shards' terms, and the shard's own in
    gradient, which is the whole penalty's gradient on the rank's rows.
    """
    if isinstance(params, nn.Module):
        paths = flax_paths(params)
        named = params.named_parameters()
    else:
        paths = {name: flax_path(name) for name in params}
        named = params.items()
    total = 0.0
    for name, p in named:
        if key_filter in paths[name]:
            term = torch.sum(torch.abs(p.to(torch.float32)) ** norm)
            if name in sharded:
                local = term.detach()
                term = term + (group_sum(local.clone()) - local)
            total = total + term
    return weight_decay * total


def replicate_tensor(x: torch.Tensor, size: int, dim: int = 0) -> torch.Tensor:
    """Each slice of ``x`` along ``dim`` repeated ``size`` times in place
    (``jnp.repeat``, torch's ``repeat_interleave``)."""
    return torch.repeat_interleave(x, size, dim=dim)


def show_attention(attentions, x_axis=None, y_axis=None, save_dir: str | None = None):
    """Draw a 2-D attention map as a heat map with matplotlib (imported
    here: without it this raises ``ImportError``), labelled by ``x_axis``
    and ``y_axis`` (lists, or comma-separated strings); saved to
    ``save_dir``, or shown when it is None."""
    try:
        import matplotlib.pyplot as plt
        import matplotlib.ticker as ticker
    except ImportError as e:  # pragma: no cover
        raise ImportError("show_attention requires matplotlib") from e

    if isinstance(attentions, torch.Tensor):
        attentions = attentions.detach().float().cpu().numpy()
    attentions = np.asarray(attentions)
    if attentions.ndim != 2:
        raise ValueError(f"attentions must be 2-D, got {attentions.shape}")

    fig = plt.figure()
    ax = fig.add_subplot(111)
    cax = ax.matshow(attentions)
    fig.colorbar(cax)
    for labels, axis, set_labels in ((x_axis, ax.xaxis, ax.set_xticklabels),
                                     (y_axis, ax.yaxis, ax.set_yticklabels)):
        if labels is not None:
            labels = labels.split(",") if isinstance(labels, str) else list(labels)
            set_labels([""] + labels)
            axis.set_major_locator(ticker.MultipleLocator(1))
    if save_dir is None:  # pragma: no cover
        plt.show()
    else:
        plt.savefig(save_dir)
    plt.close(fig)


def squash(x: torch.Tensor, dim: int = -1, eps: float = 1e-9) -> torch.Tensor:
    """The capsules' squash ``|x|²/(1+|x|²) · x/sqrt(|x|² + eps)`` over
    ``dim``; ``eps`` keeps the gradient finite at 0, as in the JAX
    package."""
    sq_norm = torch.sum(torch.square(x), dim=dim, keepdim=True)
    scale = sq_norm / (1.0 + sq_norm)
    return scale * x / torch.sqrt(sq_norm + eps)


__all__ = ["combination", "dummy_attention", "inner_product_similarity", "pair_indices",
           "regularize", "replicate_tensor", "show_attention", "squash"]
