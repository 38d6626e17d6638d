"""Helpers shared across the port."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from torecsys_tpu_torch.utils.decorator import deprecated, in_development, not_jittable
from torecsys_tpu_torch.utils.logging import TqdmHandler
from torecsys_tpu_torch.utils.operations import (
    combination,
    dummy_attention,
    inner_product_similarity,
    pair_indices,
    regularize,
    replicate_tensor,
    show_attention,
    squash,
)

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card: it resolves to ``cuda`` and raises when no CUDA
    device is present.  The CPU is used only when the caller asks for it.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: torecsys_tpu_torch runs on the GPU by default; "
                "pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def default_generator(device: torch.device, seed: int = 0,
                      generator: Optional[torch.Generator] = None) -> torch.Generator:
    """``generator`` itself, or a fresh one on ``device`` seeded with ``seed``."""
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(seed)


def get_reduction(method) -> Callable[[torch.Tensor], torch.Tensor]:
    """A reduction by name, as the JAX package's ``get_reduction``: ``"mean"``
    or ``"avg"`` → ``torch.mean``, ``"sum"`` → ``torch.sum``, ``"none"`` or
    None → the identity; a callable passes through.  Anything else raises
    ``ValueError``."""
    if callable(method):
        return method
    if method in ("mean", "avg"):
        return torch.mean
    if method == "sum":
        return torch.sum
    if method in ("none", None):
        return lambda x: x
    raise ValueError(f"unknown reduction: {method!r}")


__all__ = ["DeviceLike", "TqdmHandler", "combination", "default_generator", "deprecated",
           "dummy_attention", "get_reduction", "in_development", "inner_product_similarity",
           "not_jittable", "pair_indices", "regularize", "replicate_tensor", "resolve_device",
           "show_attention", "squash"]
