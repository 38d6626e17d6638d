"""The DCN cross network (counterpart of ``CrossNetworkLayer`` in
``torecsys_tpu/layers/ctr/cross.py``; the bilinear layers of that module
are not ported yet)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from torecsys_tpu_torch.layers.ctr.dense import xavier_uniform_
from torecsys_tpu_torch.ops.interactions import cross_layer
from torecsys_tpu_torch.utils import DeviceLike, default_generator, resolve_device


class CrossNetworkLayer(nn.Module):
    """DCN-v1 cross network, ``num_layers`` steps of ``x' = x0 * (x . w) + b
    + x`` on the flattened ``(B, N*E)`` features: ``(B, N, E) → (B, N, E)``.

    Parameters ``weight_{i}`` ``(D, 1)`` (flax's ``xavier_uniform``) and
    ``bias_{i}`` ``(D,)`` (zeros), ``D = N*E``, as in the JAX package.
    """

    def __init__(self, num_layers: int, in_features: int, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.num_layers = num_layers
        for i in range(num_layers):
            self.register_parameter(f"weight_{i}",
                                    nn.Parameter(torch.empty(in_features, 1, device=dev)))
            self.register_parameter(f"bias_{i}",
                                    nn.Parameter(torch.empty(in_features, device=dev)))
        self.reset_parameters(default_generator(dev, generator=generator))

    def reset_parameters(self, generator=None) -> None:
        for i in range(self.num_layers):
            xavier_uniform_(getattr(self, f"weight_{i}"), generator)
            with torch.no_grad():
                getattr(self, f"bias_{i}").zero_()

    def forward(self, emb_inputs: torch.Tensor) -> torch.Tensor:
        x0 = emb_inputs.reshape(emb_inputs.shape[0], -1)
        x = x0
        for i in range(self.num_layers):
            x = cross_layer(x0, x, getattr(self, f"weight_{i}")[:, 0], getattr(self, f"bias_{i}"))
        return x.reshape(emb_inputs.shape)


__all__ = ["CrossNetworkLayer"]
