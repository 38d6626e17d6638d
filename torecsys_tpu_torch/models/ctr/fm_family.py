"""FM-family CTR models (counterpart of ``torecsys_tpu/models/ctr/fm_family.py``)."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from torecsys_tpu_torch.layers.ctr import FactorizationMachineLayer, MultilayerPerceptionLayer
from torecsys_tpu_torch.models.base import CtrBaseModel, register_model
from torecsys_tpu_torch.utils import DeviceLike


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

__all__ = ["DeepFM", "DeepFactorizationMachineModel"]
