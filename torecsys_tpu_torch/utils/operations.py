"""Tensor operations (counterpart of ``torecsys_tpu/utils/operations.py``):
the StarSpace similarity and the regularizer's penalty."""

from __future__ import annotations

from typing import Mapping, Union

import torch
from torch import nn

from torecsys_tpu_torch.convert import flax_path, flax_paths


def inner_product_similarity(a: torch.Tensor, b: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Sum of elementwise products over ``dim`` (the StarSpace similarity)."""
    return torch.sum(a * b, dim=dim)


def regularize(params: Union[nn.Module, Mapping[str, torch.Tensor]], weight_decay: float = 0.01,
               norm: int = 2, key_filter: str = "kernel"):
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
            total = total + torch.sum(torch.abs(p.to(torch.float32)) ** norm)
    return weight_decay * total


__all__ = ["inner_product_similarity", "regularize"]
