"""Cross and bilinear interaction layers (counterpart of
``torecsys_tpu/layers/ctr/cross.py``): the DCN cross network, the port's
DCN-v2 low-rank cross network, the residual bilinear stack and FiBiNET's
three bilinear interactions with their dispatcher.

The FiBiNET layers' parameter is called ``weight`` in flax too, and stored
as flax stores it (not transposed); ``keeps_flax_weight`` tells
``convert.flax_paths`` so.  Their pairs ``i < j`` come from
``ops.interactions._pairs`` on the inputs' device, so a captured step never
copies indices from the host.  Their products are ``torch.matmul`` in
float32, as the JAX package's einsums compute outside any precision
``Dense``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from torecsys_tpu_torch.layers.ctr.dense import Dense, xavier_uniform_
from torecsys_tpu_torch.ops.interactions import _pairs, cross_layer, low_rank_cross
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


class LowRankCrossNetworkLayer(nn.Module):
    """DCN-v2's low-rank cross network (Wang et al., WWW 2021, arXiv:2008.13535,
    eq. 1 with ``W = U V``): ``num_layers`` steps of ``x' = x0 * (U (V x) +
    b) + x`` on the flattened ``(B, D)`` features; ``(B, D)`` or ``(B, N, E)``
    in, the same shape out.

    Layer ``i`` holds ``v_{i}``, a :class:`Dense` ``D → rank`` without bias,
    and ``u_{i}``, a :class:`Dense` ``rank → D`` whose bias is ``b``: their
    products follow the pipeline's compute dtype (under bf16 each rounds to
    bf16, and ``b`` is added in bf16), and the combine runs in the input's
    dtype.  ``ops.interactions.low_rank_cross`` takes ``b``'s add, the
    combine and, under bf16, ``x'``'s bf16 copy that the next ``v`` reads,
    in one kernel forward and one backward on the card.
    """

    def __init__(self, num_layers: int, in_features: int, rank: int,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"v_{i}", Dense(in_features, rank, use_bias=False, device=dev,
                                            generator=generator))
            self.add_module(f"u_{i}", Dense(rank, in_features, device=dev, generator=generator))

    def reset_parameters(self, generator=None) -> None:
        for i in range(self.num_layers):
            getattr(self, f"v_{i}").reset_parameters(generator)
            getattr(self, f"u_{i}").reset_parameters(generator)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x0 = inputs.reshape(inputs.shape[0], -1).contiguous()
        x = v_input = x0
        for i in range(self.num_layers):
            y, bias = getattr(self, f"u_{i}").product_and_bias(getattr(self, f"v_{i}")(v_input))
            x, v_input, x0 = low_rank_cross(x0, x, y, bias, last=i + 1 == self.num_layers)
        return x.reshape(inputs.shape)


class BilinearNetworkLayer(nn.Module):
    """Residual bilinear stack, ``num_layers`` steps of ``x_o = x0^T W_o x +
    b_o + x0_o`` on the flattened ``(B, D)`` features, ``D = N*E``:
    ``(B, N, E) → (B, N, E)``.  Parameters ``weight_{i}`` ``(D, D, D)``
    (flax's ``normal(1/D)``) and ``bias_{i}`` ``(D,)`` (zeros)."""

    def __init__(self, num_layers: int, in_features: int, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.num_layers = num_layers
        d = in_features
        for i in range(num_layers):
            self.register_parameter(f"weight_{i}",
                                    nn.Parameter(torch.empty(d, d, d, device=dev)))
            self.register_parameter(f"bias_{i}", nn.Parameter(torch.empty(d, device=dev)))
        self.reset_parameters(default_generator(dev, generator=generator))

    def reset_parameters(self, generator=None) -> None:
        for i in range(self.num_layers):
            w = getattr(self, f"weight_{i}")
            with torch.no_grad():
                w.normal_(0.0, 1.0 / w.shape[0], generator=generator)
                getattr(self, f"bias_{i}").zero_()

    def forward(self, emb_inputs: torch.Tensor) -> torch.Tensor:
        x0 = emb_inputs.reshape(emb_inputs.shape[0], -1)
        x = x0
        for i in range(self.num_layers):
            y = torch.einsum("bi,oij,bj->bo", x0, getattr(self, f"weight_{i}"), x)
            x = y + getattr(self, f"bias_{i}") + x0
        return x.reshape(emb_inputs.shape)


class _FieldBilinear(nn.Module):
    """What the FiBiNET bilinear types share: a flax ``xavier_uniform``
    ``weight`` of ``(*lead, E, E)``, kept as flax stores it."""

    keeps_flax_weight = True

    def __init__(self, lead, embed_size: int, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(*lead, embed_size, embed_size, device=dev))
        self.reset_parameters(default_generator(dev, generator=generator))

    def reset_parameters(self, generator=None) -> None:
        xavier_uniform_(self.weight, generator)


class FieldAllTypeBilinear(_FieldBilinear):
    """One shared ``W`` ``(E, E)``: ``p_ij = (v_i W) * v_j``, ``(B, N, E) →
    (B, C(N,2), E)``."""

    def __init__(self, embed_size: int, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__((), embed_size, device, generator)

    def forward(self, emb_inputs: torch.Tensor) -> torch.Tensor:
        rows, cols = _pairs(emb_inputs.shape[1], emb_inputs.device)
        projected = torch.matmul(emb_inputs, self.weight)
        return projected[:, rows, :] * emb_inputs[:, cols, :]


class FieldEachTypeBilinear(_FieldBilinear):
    """One ``W_i`` ``(E, E)`` per left field: ``p_ij = (v_i W_i) * v_j``,
    ``(B, N, E) → (B, C(N,2), E)``."""

    def __init__(self, num_fields: int, embed_size: int, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__((num_fields,), embed_size, device, generator)

    def forward(self, emb_inputs: torch.Tensor) -> torch.Tensor:
        rows, cols = _pairs(self.weight.shape[0], emb_inputs.device)
        projected = torch.matmul(emb_inputs.transpose(0, 1), self.weight).transpose(0, 1)
        return projected[:, rows, :] * emb_inputs[:, cols, :]


class FieldInteractionTypeBilinear(_FieldBilinear):
    """One ``W_ij`` ``(E, E)`` per pair: ``p_ij = (v_i W_ij) * v_j``,
    ``(B, N, E) → (B, C(N,2), E)``."""

    def __init__(self, num_fields: int, embed_size: int, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__((math.comb(num_fields, 2),), embed_size, device, generator)
        self.num_fields = num_fields

    def forward(self, emb_inputs: torch.Tensor) -> torch.Tensor:
        rows, cols = _pairs(self.num_fields, emb_inputs.device)
        left = emb_inputs[:, rows, :].transpose(0, 1)  # (P, B, E)
        return torch.matmul(left, self.weight).transpose(0, 1) * emb_inputs[:, cols, :]


BILINEAR_TYPES = ("all", "each", "interaction")


class BilinearInteractionLayer(nn.Module):
    """FiBiNET's bilinear interaction of the type ``bilinear_type`` (``"all"``,
    ``"each"`` or ``"interaction"``; anything else raises ``ValueError``),
    held as the child ``bilinear``: ``(B, N, E) → (B, C(N,2), E)``."""

    def __init__(self, num_fields: int, embed_size: int, bilinear_type: str = "all",
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if bilinear_type == "all":
            self.bilinear = FieldAllTypeBilinear(embed_size, device, generator)
        elif bilinear_type == "each":
            self.bilinear = FieldEachTypeBilinear(num_fields, embed_size, device, generator)
        elif bilinear_type == "interaction":
            self.bilinear = FieldInteractionTypeBilinear(num_fields, embed_size, device,
                                                         generator)
        else:
            raise ValueError(f"unknown bilinear_type {bilinear_type!r}")

    def reset_parameters(self, generator=None) -> None:
        self.bilinear.reset_parameters(generator)

    def forward(self, emb_inputs: torch.Tensor) -> torch.Tensor:
        return self.bilinear(emb_inputs)


__all__ = ["BILINEAR_TYPES", "BilinearInteractionLayer", "BilinearNetworkLayer",
           "CrossNetworkLayer", "FieldAllTypeBilinear", "FieldEachTypeBilinear",
           "FieldInteractionTypeBilinear", "LowRankCrossNetworkLayer"]
