"""Dense tower (counterpart of ``torecsys_tpu/layers/ctr/dense.py``)."""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from torecsys_tpu_torch.utils import DeviceLike, default_generator, resolve_device

# flax's lecun_normal: a normal truncated at two standard deviations, scaled
# so that the truncated distribution has variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def reset_linear(layer: nn.Linear, generator: Optional[torch.Generator] = None) -> None:
    """Initialize like flax ``nn.Dense``: lecun-normal weight, zero bias."""
    std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        if layer.bias is not None:
            layer.bias.zero_()


class MultilayerPerceptionLayer(nn.Module):
    """Linear → activation → dropout stack with a linear output head,
    ``(B, [N,] in_features) → (B, [N,] output_size)``.

    Sub-layers are named ``dense_0 .. dense_{k-1}`` and ``output`` as in the
    JAX package; their ``weight`` is the transpose of flax's ``kernel``.

    ``compute_dtype`` (None: float32; set by the pipeline,
    ``layers.precision``): under bf16 each product casts its input, weight
    and bias to bf16, as flax ``Dense(dtype=bf16, param_dtype=f32)`` does;
    the activations run in bf16 and the output is bf16.
    """

    def __init__(self, in_features: int, output_size: int,
                 layer_sizes: Sequence[int] = (), dropout_rate: float = 0.0,
                 activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.activation = activation
        self.dropout = nn.Dropout(dropout_rate) if dropout_rate > 0 else None
        self.hidden = []
        fan_in = in_features
        for i, size in enumerate(layer_sizes):
            layer = nn.Linear(fan_in, size, device=dev)
            self.add_module(f"dense_{i}", layer)
            self.hidden.append(f"dense_{i}")
            fan_in = size
        self.output = nn.Linear(fan_in, output_size, device=dev)
        self.compute_dtype: Optional[torch.dtype] = None
        self.reset_parameters(default_generator(dev, generator=generator))

    def reset_parameters(self, generator=None) -> None:
        for name in (*self.hidden, "output"):
            reset_linear(getattr(self, name), generator)

    def _linear(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype
        if dtype is None:
            return layer(x)
        bias = None if layer.bias is None else layer.bias.to(dtype)
        return F.linear(x.to(dtype), layer.weight.to(dtype), bias)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = inputs
        for name in self.hidden:
            x = self.activation(self._linear(getattr(self, name), x))
            if self.dropout is not None:
                x = self.dropout(x)
        return self._linear(self.output, x)
