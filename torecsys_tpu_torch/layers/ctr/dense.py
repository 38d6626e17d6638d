"""Dense layers (counterpart of ``torecsys_tpu/layers/ctr/dense.py``): the
MLP tower and the Wide layer, with :class:`Dense`, the port's counterpart of
the JAX package's precision ``Dense`` (``layers/precision.py``), and the
flax initializers the port's layers draw from."""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torecsys_tpu_torch.layers.precision import torch_linear_init
from torecsys_tpu_torch.utils import DeviceLike, default_generator, resolve_device

# flax's lecun_normal: a normal truncated at two standard deviations, scaled
# so that the truncated distribution has variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def xavier_uniform_(param: torch.Tensor, generator: Optional[torch.Generator] = None) -> None:
    """flax's ``xavier_uniform()`` in place: U(±sqrt(6 / (fan_in + fan_out)))
    with flax's fans, ``fan_in = shape[-2] * r`` and ``fan_out = shape[-1] * r``,
    ``r`` the product of the leading dimensions."""
    r = math.prod(param.shape[:-2])
    limit = math.sqrt(6.0 / ((param.shape[-2] + param.shape[-1]) * r))
    with torch.no_grad():
        param.uniform_(-limit, limit, generator=generator)


class Dense(nn.Module):
    """``y = x W^T + b``, initialized as flax ``nn.Dense`` (lecun-normal
    weight, zero bias); ``weight`` is the transpose of flax's ``kernel``.

    ``compute_dtype`` (None: float32; set by the pipeline,
    ``layers.precision``): under bf16 the product casts its input and
    weight to bf16 and rounds to bf16, then the bf16 bias is added in bf16,
    and the output is bf16, as the JAX package's precision ``Dense`` (flax
    ``Dense(dtype=bf16, param_dtype=f32)``) does.  ``follows_pipeline=False``
    keeps it out of the pipeline's compute dtype: a plain flax ``nn.Dense``
    of the JAX package, which computes in float32 on float32 inputs.
    """

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 follows_pipeline: bool = True, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.in_features = in_features
        self.follows_pipeline = follows_pipeline
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=dev))
        self.bias = nn.Parameter(torch.empty(out_features, device=dev)) if use_bias else None
        self.compute_dtype: Optional[torch.dtype] = None
        self.reset_parameters(default_generator(dev, generator=generator))

    def reset_parameters(self, generator=None) -> None:
        """flax ``nn.Dense``'s initialization: lecun-normal weight, zero bias;
        ``torch.nn.Linear``'s, ``U(+-1/sqrt(fan_in))`` for both, inside
        ``layers.precision.use_torch_linear_init`` where the layer follows
        the pipeline."""
        if self.follows_pipeline and torch_linear_init():
            bound = self.in_features ** -0.5
            with torch.no_grad():
                for t in (self.weight, self.bias):
                    if t is not None:
                        t.uniform_(-bound, bound, generator=generator)
            return
        std = math.sqrt(1.0 / self.in_features) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, bias = self.product_and_bias(x)
        return y if bias is None else y + bias

    def product_and_bias(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``forward(x)`` as ``(y, b)``, ``b`` still to be added in ``y``'s
        dtype: under a compute dtype the product rounded to it and the bias
        in it; in float32 the whole output (the product adds the bias) and
        None."""
        dtype = self.compute_dtype
        if dtype is None:
            return F.linear(x, self.weight, self.bias), None
        # the product rounded to dtype, then the bias added in dtype: two
        # roundings, as flax's Dense(dtype=bf16) takes them
        y = F.linear(x.to(dtype), self.weight.to(dtype))
        return y, None if self.bias is None else self.bias.to(dtype)


class MultilayerPerceptionLayer(nn.Module):
    """:class:`Dense` → activation → dropout stack with a :class:`Dense`
    output head, ``(B, [N,] in_features) → (B, [N,] output_size)``.

    Sub-layers are named ``dense_0 .. dense_{k-1}`` and ``output`` as in the
    JAX package.  Under a bf16 ``compute_dtype`` (set on each of them by the
    pipeline, ``layers.precision``) the activations run in bf16 and the
    output is bf16.
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
            self.add_module(f"dense_{i}", Dense(fan_in, size, device=dev))
            self.hidden.append(f"dense_{i}")
            fan_in = size
        self.output = Dense(fan_in, output_size, device=dev)
        self.reset_parameters(default_generator(dev, generator=generator))

    def reset_parameters(self, generator=None) -> None:
        for name in (*self.hidden, "output"):
            getattr(self, name).reset_parameters(generator)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = inputs
        for name in self.hidden:
            x = self.activation(getattr(self, name)(x))
            if self.dropout is not None:
                x = self.dropout(x)
        return self.output(x)


class WideLayer(nn.Module):
    """One linear layer (+ dropout), the 'wide' half of Wide&Deep:
    ``(B, [N,] in_features) → (B, [N,] output_size)``; the layer is named
    ``linear`` as in the JAX package."""

    def __init__(self, in_features: int, output_size: int, dropout_rate: float = 0.0,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear = Dense(in_features, output_size, device=device, generator=generator)
        self.dropout = nn.Dropout(dropout_rate) if dropout_rate > 0 else None

    def reset_parameters(self, generator=None) -> None:
        self.linear.reset_parameters(generator)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = self.linear(inputs)
        return self.dropout(x) if self.dropout is not None else x
