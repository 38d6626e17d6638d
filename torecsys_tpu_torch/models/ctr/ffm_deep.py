"""Deep field-aware models (counterpart of ``torecsys_tpu/models/ctr/ffm_deep.py``):
DeepFFM (alias FNFM, FieldAwareNeuralFactorizationMachine) and FAT-DeepFFM
(alias FieldAttentiveDeepFieldAwareFactorizationMachine), each over the
``(B, N*N, E)`` ``field_emb_inputs`` of a field-aware embedding, returning
raw ``(B, 1)`` scores.

``from_inputs`` reads ``num_fields`` and ``embed_size`` off the field-aware
table (the tower's width is ``C(N, 2) * E``); the other arguments are the
JAX package's.  Under ``set_compute_dtype("bfloat16")`` the tower and the
excitation's products run in bf16, the FFM interaction in float32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from torecsys_tpu_torch.layers.ctr import (
    ComposeExcitationNetworkLayer,
    FieldAwareFactorizationMachineLayer,
    MultilayerPerceptionLayer,
)
from torecsys_tpu_torch.models.base import CtrBaseModel, register_model
from torecsys_tpu_torch.utils import DeviceLike, default_generator, resolve_device

Activation = Callable[[torch.Tensor], torch.Tensor]


def _field_aware(inputs, kwargs) -> dict:
    table = inputs.schema["field_emb_inputs"]
    kwargs.setdefault("num_fields", len(table.fields))
    kwargs.setdefault("embed_size", table.embed_size)
    return kwargs


class _DeepFieldAware(CtrBaseModel):
    """The FFM interaction and its tower, shared by both models."""

    def __init__(self, num_fields: int, embed_size: int, deep_layer_sizes: Sequence[int],
                 ffm_dropout_rate: float, deep_dropout_rate: float, activation: Activation,
                 device: torch.device):
        super().__init__()
        self.ffm = FieldAwareFactorizationMachineLayer(num_fields, dropout_rate=ffm_dropout_rate)
        self.deep = MultilayerPerceptionLayer(
            math.comb(num_fields, 2) * embed_size, 1, layer_sizes=tuple(deep_layer_sizes),
            dropout_rate=deep_dropout_rate, activation=activation, device=device)

    @classmethod
    def from_inputs(cls, inputs, **kwargs):
        return cls(**_field_aware(inputs, kwargs))

    def _first_and_deep(self, field_emb: torch.Tensor):
        first = torch.sum(field_emb, dim=(1, 2))[:, None]  # (B, 1)
        second = self.ffm(field_emb)  # (B, C(N,2), E)
        return first, self.deep(second.reshape(second.shape[0], -1))


@register_model("DeepFFM", "FNFM", "FieldAwareNeuralFactorizationMachine")
class DeepFieldAwareFactorizationMachineModel(_DeepFieldAware):
    """Σ field-aware embeddings (first order) + DNN(flatten(FFM)) → ``(B, 1)``."""

    def __init__(self, num_fields: int, embed_size: int,
                 deep_layer_sizes: Sequence[int] = (64, 64), ffm_dropout_rate: float = 0.0,
                 deep_dropout_rate: float = 0.0, activation: Activation = torch.relu,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        dev = resolve_device(device)
        super().__init__(num_fields, embed_size, deep_layer_sizes, ffm_dropout_rate,
                         deep_dropout_rate, activation, dev)
        self.reset_parameters(default_generator(dev, generator=generator))

    def forward(self, field_emb_inputs: torch.Tensor) -> torch.Tensor:
        first, second = self._first_and_deep(field_emb_inputs)
        return second + first


@register_model("FATDeepFFM", "FieldAttentiveDeepFieldAwareFactorizationMachine")
class FieldAttentiveDeepFieldAwareFactorizationMachineModel(_DeepFieldAware):
    """The CEN over the N² field-aware embeddings (``squared``), then as
    DeepFFM on the re-weighted embeddings → ``(B, 1)``."""

    def __init__(self, num_fields: int, embed_size: int, reduction: int = 1,
                 deep_layer_sizes: Sequence[int] = (64, 64), ffm_dropout_rate: float = 0.0,
                 deep_dropout_rate: float = 0.0, activation: Activation = torch.relu,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        dev = resolve_device(device)
        super().__init__(num_fields, embed_size, deep_layer_sizes, ffm_dropout_rate,
                         deep_dropout_rate, activation, dev)
        self.cen = ComposeExcitationNetworkLayer(num_fields, reduction=reduction, squared=True,
                                                 device=dev)
        self.reset_parameters(default_generator(dev, generator=generator))

    def forward(self, field_emb_inputs: torch.Tensor) -> torch.Tensor:
        first, second = self._first_and_deep(self.cen(field_emb_inputs))
        return first + second


DeepFFM = DeepFieldAwareFactorizationMachineModel
FNFM = DeepFieldAwareFactorizationMachineModel
FieldAwareNeuralFactorizationMachine = DeepFieldAwareFactorizationMachineModel
FATDeepFFM = FieldAttentiveDeepFieldAwareFactorizationMachineModel

__all__ = ["DeepFFM", "DeepFieldAwareFactorizationMachineModel", "FATDeepFFM", "FNFM",
           "FieldAttentiveDeepFieldAwareFactorizationMachineModel",
           "FieldAwareNeuralFactorizationMachine"]
