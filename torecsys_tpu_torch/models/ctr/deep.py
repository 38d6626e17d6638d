"""Deep-interaction CTR models (counterpart of ``torecsys_tpu/models/ctr/deep.py``):
PNN, DCN, xDeepFM, NCF and Wide&Deep, registered under the JAX package's
names and aliases, each returning raw ``(B, 1)`` scores.

As in ``fm_family``, ``from_inputs`` reads the widths off the ``Inputs``
(``feat_size``, the flattened width of ``feat_inputs``; ``num_fields`` and
``embed_size`` of ``emb_inputs``); every other argument is the JAX
package's.  Under ``set_compute_dtype("bfloat16")`` the products of the
towers and the linear heads run in bf16 and every other layer (the
product, cross and CIN interactions, the batch norm) in float32, as the
JAX package's layers do.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from torecsys_tpu_torch.layers.ctr import (
    CompressInteractionNetworkLayer,
    CrossNetworkLayer,
    Dense,
    InnerProductNetworkLayer,
    MultilayerPerceptionLayer,
    OuterProductNetworkLayer,
    WideLayer,
)
from torecsys_tpu_torch.layers.emb import GeneralizedMatrixFactorizationLayer
from torecsys_tpu_torch.models.base import CtrBaseModel, input_shape, register_model
from torecsys_tpu_torch.utils import DeviceLike, default_generator, resolve_device

Activation = Callable[[torch.Tensor], torch.Tensor]


def _feat_size(inputs) -> int:
    return math.prod(input_shape(inputs, "feat_inputs"))


@register_model("PNN", "ProductNeuralNetwork")
class ProductNeuralNetworkModel(CtrBaseModel):
    """concat(product interactions, first-order[, bias]) → DNN → ``(B, 1)``;
    ``prod_method`` is ``'inner'`` or ``'outer'`` (with ``kernel_type``)."""

    def __init__(self, feat_size: int, num_fields: int, embed_size: int,
                 deep_layer_sizes: Sequence[int] = (64, 64), prod_method: str = "inner",
                 kernel_type: str = "mat", use_bias: bool = True,
                 deep_dropout_rate: float = 0.0, activation: Activation = torch.relu,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if prod_method == "inner":
            self.pnn = InnerProductNetworkLayer()
        elif prod_method == "outer":
            self.pnn = OuterProductNetworkLayer(num_fields, embed_size, kernel_type=kernel_type,
                                                device=dev, generator=generator)
        else:
            raise ValueError(f"unknown prod_method {prod_method!r}")
        self.bias = nn.Parameter(torch.empty((1, 1), device=dev)) if use_bias else None
        in_features = math.comb(num_fields, 2) + feat_size + (1 if use_bias else 0)
        self.deep = MultilayerPerceptionLayer(
            in_features, 1, layer_sizes=tuple(deep_layer_sizes), dropout_rate=deep_dropout_rate,
            activation=activation, device=dev, generator=generator)
        self.reset_parameters(default_generator(dev, generator=generator))

    @classmethod
    def from_inputs(cls, inputs, **kwargs):
        n, e = input_shape(inputs, "emb_inputs")
        kwargs.setdefault("feat_size", _feat_size(inputs))
        kwargs.setdefault("num_fields", n)
        kwargs.setdefault("embed_size", e)
        return cls(**kwargs)

    def reset_parameters(self, generator=None) -> None:
        if isinstance(self.pnn, OuterProductNetworkLayer):
            self.pnn.reset_parameters(generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.uniform_(0.0, 1.0, generator=generator)
        self.deep.reset_parameters(generator)

    def forward(self, feat_inputs: torch.Tensor, emb_inputs: torch.Tensor) -> torch.Tensor:
        b = feat_inputs.shape[0]
        parts = [self.pnn(emb_inputs), feat_inputs.reshape(b, -1)]
        if self.bias is not None:
            parts.append(self.bias.expand(b, 1))
        return self.deep(torch.cat(parts, dim=1))


@register_model("DCN", "DeepAndCrossNetwork")
class DeepAndCrossNetworkModel(CtrBaseModel):
    """Cross network ∥ a deep tower applied to each field's row → concat →
    linear head ``fc`` → ``(B, output_size)``.  Its only input is
    ``emb_inputs``."""

    def __init__(self, num_fields: int, embed_size: int, cross_num_layers: int = 3,
                 deep_output_size: int = 16, deep_layer_sizes: Sequence[int] = (64, 64),
                 output_size: int = 1, deep_dropout_rate: float = 0.0,
                 activation: Activation = torch.relu, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cross = CrossNetworkLayer(cross_num_layers, num_fields * embed_size, device=dev,
                                       generator=generator)
        self.deep = MultilayerPerceptionLayer(
            embed_size, deep_output_size, layer_sizes=tuple(deep_layer_sizes),
            dropout_rate=deep_dropout_rate, activation=activation, device=dev,
            generator=generator)
        self.fc = Dense(num_fields * (embed_size + deep_output_size), output_size, device=dev,
                        generator=generator)

    @classmethod
    def from_inputs(cls, inputs, **kwargs):
        n, e = input_shape(inputs, "emb_inputs")
        kwargs.setdefault("num_fields", n)
        kwargs.setdefault("embed_size", e)
        return cls(**kwargs)

    def forward(self, emb_inputs: torch.Tensor) -> torch.Tensor:
        cross_out = self.cross(emb_inputs)  # (B, N, E)
        deep_out = self.deep(emb_inputs)  # (B, N, O)
        cat = torch.cat([cross_out, deep_out], dim=2).reshape(emb_inputs.shape[0], -1)
        return self.fc(cat)


@register_model("XDeepFM", "xDeepFM")
class XDeepFactorizationMachineModel(CtrBaseModel):
    """first-order + CIN + DNN (+ bias) → ``(B, 1)``.  The CIN's batch norm
    (``use_batchnorm``) keeps running statistics, the port's ``batch_stats``
    (``train.state.batch_stats``)."""

    def __init__(self, embed_size: int, num_fields: int,
                 cin_layer_sizes: Sequence[int] = (128, 128),
                 deep_layer_sizes: Sequence[int] = (64, 64), cin_is_direct: bool = False,
                 use_bias: bool = True, use_batchnorm: bool = True,
                 deep_dropout_rate: float = 0.0, activation: Activation = torch.relu,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cin = CompressInteractionNetworkLayer(
            embed_size, num_fields, output_size=1, layer_sizes=tuple(cin_layer_sizes),
            is_direct=cin_is_direct, use_batchnorm=use_batchnorm, activation=activation,
            device=dev, generator=generator)
        self.deep = MultilayerPerceptionLayer(
            num_fields * embed_size, 1, layer_sizes=tuple(deep_layer_sizes),
            dropout_rate=deep_dropout_rate, activation=activation, device=dev,
            generator=generator)
        self.bias = nn.Parameter(torch.zeros((1, 1), device=dev)) if use_bias else None

    @classmethod
    def from_inputs(cls, inputs, **kwargs):
        n, e = input_shape(inputs, "emb_inputs")
        kwargs.setdefault("num_fields", n)
        kwargs.setdefault("embed_size", e)
        return cls(**kwargs)

    def reset_parameters(self, generator=None) -> None:
        self.cin.reset_parameters(generator)
        self.deep.reset_parameters(generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, feat_inputs: torch.Tensor, emb_inputs: torch.Tensor) -> torch.Tensor:
        cin_out = self.cin(emb_inputs)  # (B, 1)
        deep_out = self.deep(emb_inputs.reshape(emb_inputs.shape[0], -1))
        out = torch.sum(feat_inputs, dim=1) + cin_out + deep_out
        return out + self.bias if self.bias is not None else out


@register_model("NCF", "NeuralCollaborativeFiltering")
class NeuralCollaborativeFilteringModel(CtrBaseModel):
    """GMF + a deep tower over the ``(B, 2, E)`` user and item rows →
    ``(B, 1)``."""

    def __init__(self, embed_size: int, deep_layer_sizes: Sequence[int] = (64, 64),
                 deep_dropout_rate: float = 0.0, activation: Activation = torch.relu,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.deep = MultilayerPerceptionLayer(
            2 * embed_size, 1, layer_sizes=tuple(deep_layer_sizes),
            dropout_rate=deep_dropout_rate, activation=activation, device=device,
            generator=generator)
        self.glm = GeneralizedMatrixFactorizationLayer()

    @classmethod
    def from_inputs(cls, inputs, **kwargs):
        n, e = input_shape(inputs, "emb_inputs")
        if n != 2:
            raise ValueError(f"NCF takes the (B, 2, E) user and item rows, got {n} rows")
        kwargs.setdefault("embed_size", e)
        return cls(**kwargs)

    def forward(self, emb_inputs: torch.Tensor) -> torch.Tensor:
        deep_out = self.deep(emb_inputs.reshape(emb_inputs.shape[0], -1))
        return self.glm(emb_inputs) + deep_out


@register_model("WideAndDeep")
class WideAndDeepModel(CtrBaseModel):
    """Wide(first-order) ∥ a deep tower applied to each field's row → concat
    → the ``output`` Wide layer → ``(B, 1)``."""

    def __init__(self, feat_size: int, num_fields: int, embed_size: int,
                 deep_layer_sizes: Sequence[int] = (64, 64), wide_dropout_rate: float = 0.0,
                 deep_dropout_rate: float = 0.0, out_dropout_rate: float = 0.0,
                 activation: Activation = torch.relu, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.wide = WideLayer(feat_size, 1, dropout_rate=wide_dropout_rate, device=dev,
                              generator=generator)
        self.deep = MultilayerPerceptionLayer(
            embed_size, 1, layer_sizes=tuple(deep_layer_sizes), dropout_rate=deep_dropout_rate,
            activation=activation, device=dev, generator=generator)
        self.output = WideLayer(num_fields + 1, 1, dropout_rate=out_dropout_rate, device=dev,
                                generator=generator)

    @classmethod
    def from_inputs(cls, inputs, **kwargs):
        n, e = input_shape(inputs, "emb_inputs")
        kwargs.setdefault("feat_size", _feat_size(inputs))
        kwargs.setdefault("num_fields", n)
        kwargs.setdefault("embed_size", e)
        return cls(**kwargs)

    def forward(self, feat_inputs: torch.Tensor, emb_inputs: torch.Tensor) -> torch.Tensor:
        wide_out = self.wide(feat_inputs.reshape(feat_inputs.shape[0], -1))  # (B, 1)
        deep_out = self.deep(emb_inputs)[..., 0]  # (B, N)
        return self.output(torch.cat([wide_out, deep_out], dim=1))


PNN = ProductNeuralNetworkModel
DCN = DeepAndCrossNetworkModel
xDeepFM = XDeepFactorizationMachineModel
NCF = NeuralCollaborativeFilteringModel
WideAndDeep = WideAndDeepModel

__all__ = ["DCN", "DeepAndCrossNetworkModel", "NCF", "NeuralCollaborativeFilteringModel", "PNN",
           "ProductNeuralNetworkModel", "WideAndDeep", "WideAndDeepModel",
           "XDeepFactorizationMachineModel", "xDeepFM"]
