"""FM-family CTR models (counterpart of ``torecsys_tpu/models/ctr/fm_family.py``):
LR, FM, FMNN, FFM, AFM, NFM and DeepFM, registered under the JAX package's
names and aliases.  All return raw ``(B, 1)`` scores except LR, which
applies a sigmoid (``outputs_probability``), as the JAX package's does.

A torch module is built with its input widths: each model's
``from_inputs`` reads them off the ``Inputs`` it will be applied to
(``feat_size``, the flattened width of ``feat_inputs``; ``num_fields`` and
``embed_size`` of ``emb_inputs``), and the other arguments are the JAX
package's."""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from torecsys_tpu_torch.layers.ctr import (
    AttentionalFactorizationMachineLayer,
    FactorizationMachineLayer,
    FieldAwareFactorizationMachineLayer,
    MultilayerPerceptionLayer,
)
from torecsys_tpu_torch.layers.ctr.dense import Dense
from torecsys_tpu_torch.models.base import CtrBaseModel, input_shape, register_model
from torecsys_tpu_torch.utils import DeviceLike, default_generator, resolve_device


def _bias(device) -> nn.Parameter:
    """A model's ``(1, 1)`` bias, drawn by :func:`_reset_bias`."""
    return nn.Parameter(torch.empty((1, 1), device=device))


def _reset_bias(bias: Optional[nn.Parameter], generator) -> None:
    """U[0, 1), as flax's ``uniform(scale=1.0)`` (the JAX package's ``_bias``)."""
    if bias is not None:
        with torch.no_grad():
            bias.uniform_(0.0, 1.0, generator=generator)


@register_model("LR")
class LogisticRegressionModel(CtrBaseModel):
    """Linear + sigmoid over the flattened first-order features:
    ``feat_inputs (B, N, k) → (B, output_size)`` probabilities.

    The linear layer is a :class:`~torecsys_tpu_torch.layers.ctr.dense.Dense`
    named ``linear`` (flax ``Dense``'s initialization; under a bf16
    ``compute_dtype`` its product runs in bf16, as the JAX package's
    precision ``Dense`` does).
    """

    outputs_probability = True

    def __init__(self, in_features: int, output_size: int = 1, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear = Dense(in_features, output_size, device=device, generator=generator)

    @classmethod
    def from_inputs(cls, inputs, **kwargs):
        kwargs.setdefault("in_features", math.prod(input_shape(inputs, "feat_inputs")))
        return cls(**kwargs)

    def forward(self, feat_inputs: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.linear(feat_inputs.reshape(feat_inputs.shape[0], -1)))


@register_model("FM")
class FactorizationMachineModel(CtrBaseModel):
    """bias + Σ first-order + Σ_E FM second-order → ``(B, 1)``.

    ``bias`` is a ``(1, 1)`` parameter drawn from U[0, 1), as flax's
    ``uniform(scale=1.0)``.
    """

    def __init__(self, use_bias: bool = True, dropout_rate: float = 0.0,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.fm = FactorizationMachineLayer(dropout_rate=dropout_rate)
        self.bias = _bias(dev) if use_bias else None
        self.reset_parameters(default_generator(dev, generator=generator))

    def reset_parameters(self, generator=None) -> None:
        _reset_bias(self.bias, generator)

    def forward(self, feat_inputs: torch.Tensor, emb_inputs: torch.Tensor) -> torch.Tensor:
        fm_first = torch.sum(feat_inputs, dim=1)  # (B, 1)
        fm_second = self.fm(emb_inputs)  # (B, E)
        out = torch.sum(fm_second, dim=1, keepdim=True) + fm_first
        if self.bias is not None:
            out = out + self.bias
        return out


@register_model("FMNN", "FactorizationMachineSupportedNeuralNetwork")
class FactorizationMachineSupportedNeuralNetworkModel(CtrBaseModel):
    """concat(first-order, FM) → DNN → ``(B, deep_output_size)``: the tower
    takes ``feat_size + embed_size`` features."""

    def __init__(self, feat_size: int, embed_size: int, deep_output_size: int = 1,
                 deep_layer_sizes: Sequence[int] = (64, 64), fm_dropout_rate: float = 0.0,
                 deep_dropout_rate: float = 0.0,
                 activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fm = FactorizationMachineLayer(dropout_rate=fm_dropout_rate)
        self.deep = MultilayerPerceptionLayer(
            feat_size + embed_size, deep_output_size, layer_sizes=tuple(deep_layer_sizes),
            dropout_rate=deep_dropout_rate, activation=activation, device=device,
            generator=generator)

    @classmethod
    def from_inputs(cls, inputs, **kwargs):
        kwargs.setdefault("feat_size", math.prod(input_shape(inputs, "feat_inputs")))
        kwargs.setdefault("embed_size", input_shape(inputs, "emb_inputs")[1])
        return cls(**kwargs)

    def forward(self, feat_inputs: torch.Tensor, emb_inputs: torch.Tensor) -> torch.Tensor:
        fm_first = feat_inputs.reshape(feat_inputs.shape[0], -1)  # (B, N)
        fm_out = torch.cat([fm_first, self.fm(emb_inputs)], dim=1)
        return self.deep(fm_out)


@register_model("FFM")
class FieldAwareFactorizationMachineModel(CtrBaseModel):
    """bias + Σ first-order + ΣΣ FFM interaction → ``(B, 1)``, over the
    ``(B, N*N, E)`` ``field_emb_inputs`` of a field-aware embedding."""

    def __init__(self, num_fields: int, dropout_rate: float = 0.0, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.ffm = FieldAwareFactorizationMachineLayer(num_fields, dropout_rate=dropout_rate)
        self.bias = _bias(dev)
        self.reset_parameters(default_generator(dev, generator=generator))

    @classmethod
    def from_inputs(cls, inputs, **kwargs):
        kwargs.setdefault("num_fields", len(inputs.schema["field_emb_inputs"].fields))
        return cls(**kwargs)

    def reset_parameters(self, generator=None) -> None:
        _reset_bias(self.bias, generator)

    def forward(self, feat_inputs: torch.Tensor, field_emb_inputs: torch.Tensor) -> torch.Tensor:
        ffm_first = torch.sum(feat_inputs, dim=1)  # (B, 1)
        ffm_second = self.ffm(field_emb_inputs)  # (B, P, E)
        return torch.sum(ffm_second, dim=(1, 2))[:, None] + ffm_first + self.bias


@register_model("AFM")
class AttentionalFactorizationMachineModel(CtrBaseModel):
    """bias + Σ first-order + Σ_E AFM attention-pooled interaction → ``(B, 1)``."""

    def __init__(self, embed_size: int, attn_size: int, use_bias: bool = True,
                 dropout_rate: float = 0.0, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.afm = AttentionalFactorizationMachineLayer(embed_size, attn_size,
                                                        dropout_rate=dropout_rate, device=dev,
                                                        generator=generator)
        self.bias = _bias(dev) if use_bias else None
        self.reset_parameters(default_generator(dev, generator=generator))

    @classmethod
    def from_inputs(cls, inputs, **kwargs):
        kwargs.setdefault("embed_size", input_shape(inputs, "emb_inputs")[1])
        return cls(**kwargs)

    def reset_parameters(self, generator=None) -> None:
        self.afm.reset_parameters(generator)
        _reset_bias(self.bias, generator)

    def forward(self, feat_inputs: torch.Tensor, emb_inputs: torch.Tensor) -> torch.Tensor:
        afm_first = torch.sum(feat_inputs, dim=1)  # (B, 1)
        afm_second, _ = self.afm(emb_inputs)
        out = torch.sum(afm_second, dim=1, keepdim=True) + afm_first
        return out + self.bias if self.bias is not None else out


@register_model("NFM", "NeuralFactorizationMachine")
class NeuralFactorizationMachineModel(CtrBaseModel):
    """bias + Σ first-order + DNN(FM(emb)) → ``(B, 1)``."""

    def __init__(self, embed_size: int, deep_layer_sizes: Sequence[int] = (64, 64),
                 use_bias: bool = True, fm_dropout_rate: float = 0.0,
                 deep_dropout_rate: float = 0.0,
                 activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.fm = FactorizationMachineLayer(dropout_rate=fm_dropout_rate)
        self.deep = MultilayerPerceptionLayer(
            embed_size, 1, layer_sizes=tuple(deep_layer_sizes), dropout_rate=deep_dropout_rate,
            activation=activation, device=dev, generator=generator)
        self.bias = _bias(dev) if use_bias else None
        self.reset_parameters(default_generator(dev, generator=generator))

    @classmethod
    def from_inputs(cls, inputs, **kwargs):
        kwargs.setdefault("embed_size", input_shape(inputs, "emb_inputs")[1])
        return cls(**kwargs)

    def reset_parameters(self, generator=None) -> None:
        self.deep.reset_parameters(generator)
        _reset_bias(self.bias, generator)

    def forward(self, feat_inputs: torch.Tensor, emb_inputs: torch.Tensor) -> torch.Tensor:
        out = self.deep(self.fm(emb_inputs)) + torch.sum(feat_inputs, dim=1)
        return out + self.bias if self.bias is not None else out


@register_model("DeepFM")
class DeepFactorizationMachineModel(CtrBaseModel):
    """(Σ first-order + Σ FM) + DNN(flat embeddings) → ``(B, 1)``.

    ``num_fields`` and ``embed_size`` describe ``emb_inputs`` ``(B, N, E)``;
    the tower takes the flat ``N*E`` embedding.
    """

    def __init__(self, num_fields: int, embed_size: int,
                 deep_layer_sizes: Sequence[int] = (64, 64),
                 fm_dropout_rate: float = 0.0, deep_dropout_rate: float = 0.0,
                 activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fm = FactorizationMachineLayer(dropout_rate=fm_dropout_rate)
        self.deep = MultilayerPerceptionLayer(
            num_fields * embed_size, 1, layer_sizes=tuple(deep_layer_sizes),
            dropout_rate=deep_dropout_rate, activation=activation,
            device=device, generator=generator,
        )

    @classmethod
    def from_inputs(cls, inputs, **kwargs):
        n, e = input_shape(inputs, "emb_inputs")
        kwargs.setdefault("num_fields", n)
        kwargs.setdefault("embed_size", e)
        return cls(**kwargs)

    def forward(self, feat_inputs: torch.Tensor, emb_inputs: torch.Tensor) -> torch.Tensor:
        b = feat_inputs.shape[0]
        fm_first = feat_inputs.reshape(b, -1)  # (B, N)
        fm_second = self.fm(emb_inputs)  # (B, E)
        fm_out = torch.sum(fm_second, dim=1, keepdim=True) + torch.sum(
            fm_first, dim=1, keepdim=True
        )
        deep_out = self.deep(emb_inputs.reshape(b, -1))
        return deep_out + fm_out


DeepFM = DeepFactorizationMachineModel
LR = LogisticRegressionModel
FM = FactorizationMachineModel
FMNN = FactorizationMachineSupportedNeuralNetworkModel
FFM = FieldAwareFactorizationMachineModel
AFM = AttentionalFactorizationMachineModel
NFM = NeuralFactorizationMachineModel

__all__ = ["AFM", "AttentionalFactorizationMachineModel", "DeepFM",
           "DeepFactorizationMachineModel", "FFM", "FM", "FMNN", "FactorizationMachineModel",
           "FactorizationMachineSupportedNeuralNetworkModel",
           "FieldAwareFactorizationMachineModel", "LR", "LogisticRegressionModel", "NFM",
           "NeuralFactorizationMachineModel"]
