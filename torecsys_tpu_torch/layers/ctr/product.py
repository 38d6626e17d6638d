"""Product-based interaction layers, PNN's inner and outer product networks
(counterpart of ``torecsys_tpu/layers/ctr/product.py``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from torecsys_tpu_torch.layers.ctr.dense import xavier_uniform_
from torecsys_tpu_torch.ops.interactions import inner_product_pairs, outer_product_pairs
from torecsys_tpu_torch.utils import DeviceLike, default_generator, resolve_device


class InnerProductNetworkLayer(nn.Module):
    """Pairwise inner products ``<v_i, v_j>`` for i<j: ``(B, N, E) → (B, C(N,2))``."""

    def forward(self, emb_inputs: torch.Tensor) -> torch.Tensor:
        return inner_product_pairs(emb_inputs)


class OuterProductNetworkLayer(nn.Module):
    """Kernel-compressed pairwise outer products: ``(B, N, E) → (B, C(N,2))``
    with a learned kernel of type ``mat`` (E, P, E), ``vec`` (P, E) or
    ``num`` (P, 1), drawn as flax's ``xavier_uniform``.

    As for every flax ``kernel``, the parameter is named ``weight`` and
    holds the transpose of flax's (its axes reversed: ``kernel.T``);
    :attr:`kernel` is the JAX package's layout.
    """

    def __init__(self, num_fields: int, embed_size: int, kernel_type: str = "mat",
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        p = math.comb(num_fields, 2)
        shapes = {"mat": (embed_size, p, embed_size), "vec": (p, embed_size), "num": (p, 1)}
        if kernel_type not in shapes:
            raise ValueError(f"unknown kernel_type {kernel_type!r}")
        self.kernel_type = kernel_type
        self.weight = nn.Parameter(torch.empty(shapes[kernel_type][::-1], device=dev))
        self.reset_parameters(default_generator(dev, generator=generator))

    @property
    def kernel(self) -> torch.Tensor:
        return self.weight.permute(*reversed(range(self.weight.dim())))

    def reset_parameters(self, generator=None) -> None:
        xavier_uniform_(self.kernel, generator)

    def forward(self, emb_inputs: torch.Tensor) -> torch.Tensor:
        return outer_product_pairs(emb_inputs, self.kernel, self.kernel_type)


__all__ = ["InnerProductNetworkLayer", "OuterProductNetworkLayer"]
