"""FM-family CTR models (counterpart of ``torecsys_tpu/models/ctr/fm_family.py``):
LR, FM and DeepFM.  All return raw ``(B, 1)`` scores except LR, which
applies a sigmoid (``outputs_probability``), as the JAX package's does."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from torecsys_tpu_torch.layers.ctr import FactorizationMachineLayer, MultilayerPerceptionLayer
from torecsys_tpu_torch.layers.ctr.dense import reset_linear
from torecsys_tpu_torch.models.base import CtrBaseModel, register_model
from torecsys_tpu_torch.utils import DeviceLike, default_generator, resolve_device


@register_model("LR")
class LogisticRegressionModel(CtrBaseModel):
    """Linear + sigmoid over the flattened first-order features:
    ``feat_inputs (B, N, k) → (B, output_size)`` probabilities.

    The linear layer is named ``linear`` and initialized as flax ``Dense``
    (lecun-normal weight, zero bias); under a bf16 ``compute_dtype`` its
    product runs in bf16, as the JAX package's precision ``Dense`` does.
    """

    outputs_probability = True

    def __init__(self, in_features: int, output_size: int = 1, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.linear = nn.Linear(in_features, output_size, device=dev)
        self.compute_dtype: Optional[torch.dtype] = None
        self.reset_parameters(default_generator(dev, generator=generator))

    @classmethod
    def from_inputs(cls, inputs, **kwargs):
        feat = inputs.schema["feat_inputs"]
        kwargs.setdefault("in_features", len(feat.fields) * feat.embed_size)
        return cls(**kwargs)

    def reset_parameters(self, generator=None) -> None:
        reset_linear(self.linear, generator)

    def forward(self, feat_inputs: torch.Tensor) -> torch.Tensor:
        flat = feat_inputs.reshape(feat_inputs.shape[0], -1)
        dtype = self.compute_dtype
        if dtype is None:
            return torch.sigmoid(self.linear(flat))
        return torch.sigmoid(F.linear(flat.to(dtype), self.linear.weight.to(dtype),
                                      self.linear.bias.to(dtype)))


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
        self.bias = nn.Parameter(torch.empty((1, 1), device=dev)) if use_bias else None
        self.reset_parameters(default_generator(dev, generator=generator))

    def reset_parameters(self, generator=None) -> None:
        if self.bias is not None:
            with torch.no_grad():
                self.bias.uniform_(0.0, 1.0, generator=generator)

    def forward(self, feat_inputs: torch.Tensor, emb_inputs: torch.Tensor) -> torch.Tensor:
        fm_first = torch.sum(feat_inputs, dim=1)  # (B, 1)
        fm_second = self.fm(emb_inputs)  # (B, E)
        out = torch.sum(fm_second, dim=1, keepdim=True) + fm_first
        if self.bias is not None:
            out = out + self.bias
        return out


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
        emb = inputs.schema["emb_inputs"]
        kwargs.setdefault("num_fields", len(emb.fields))
        kwargs.setdefault("embed_size", emb.embed_size)
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

__all__ = ["DeepFM", "DeepFactorizationMachineModel", "FM", "FactorizationMachineModel", "LR",
           "LogisticRegressionModel"]
