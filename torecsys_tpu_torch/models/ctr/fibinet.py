"""FiBiNET (counterpart of ``torecsys_tpu/models/ctr/fibinet.py``): the
SENET re-weighting, the bilinear interaction of the raw and of the
re-weighted embeddings, their concatenation and a DNN head.

``from_inputs`` reads ``num_fields`` and ``embed_size`` off ``emb_inputs``;
the other arguments are the JAX package's.  Under
``set_compute_dtype("bfloat16")`` the tower and the SENET's products run in
bf16, the bilinear interactions in float32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from torecsys_tpu_torch.layers.ctr import (
    BilinearInteractionLayer,
    ComposeExcitationNetworkLayer,
    MultilayerPerceptionLayer,
)
from torecsys_tpu_torch.models.base import CtrBaseModel, input_shape, register_model
from torecsys_tpu_torch.utils import DeviceLike, default_generator, resolve_device


@register_model("FiBiNET")
class FeatureImportanceAndBilinearFeatureInteractionNetwork(CtrBaseModel):
    """SENET ∥ raw → two bilinear interactions → concat → DNN →
    ``(B, deep_output_size)``; its only input is ``emb_inputs``."""

    def __init__(self, num_fields: int, embed_size: int, senet_reduction: int = 1,
                 deep_output_size: int = 1, deep_layer_sizes: Sequence[int] = (64, 64),
                 bilinear_type: str = "all", deep_dropout_rate: float = 0.0,
                 activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.senet = ComposeExcitationNetworkLayer(num_fields, reduction=senet_reduction,
                                                   device=dev)
        self.emb_bilinear = BilinearInteractionLayer(num_fields, embed_size, bilinear_type,
                                                     device=dev)
        self.senet_bilinear = BilinearInteractionLayer(num_fields, embed_size, bilinear_type,
                                                       device=dev)
        self.deep = MultilayerPerceptionLayer(
            2 * math.comb(num_fields, 2) * embed_size, deep_output_size,
            layer_sizes=tuple(deep_layer_sizes), dropout_rate=deep_dropout_rate,
            activation=activation, device=dev)
        self.reset_parameters(default_generator(dev, generator=generator))

    @classmethod
    def from_inputs(cls, inputs, **kwargs):
        n, e = input_shape(inputs, "emb_inputs")
        kwargs.setdefault("num_fields", n)
        kwargs.setdefault("embed_size", e)
        return cls(**kwargs)

    def forward(self, emb_inputs: torch.Tensor) -> torch.Tensor:
        b = emb_inputs.shape[0]
        senet_emb = self.senet(emb_inputs)
        emb_bi = self.emb_bilinear(emb_inputs)  # (B, C(N,2), E)
        senet_bi = self.senet_bilinear(senet_emb)
        return self.deep(torch.cat([emb_bi.reshape(b, -1), senet_bi.reshape(b, -1)], dim=1))


FiBiNET = FeatureImportanceAndBilinearFeatureInteractionNetwork

__all__ = ["FeatureImportanceAndBilinearFeatureInteractionNetwork", "FiBiNET"]
