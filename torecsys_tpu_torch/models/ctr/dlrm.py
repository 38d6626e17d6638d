"""DLRM-DCNv2, the model of MLPerf Training's recommendation benchmark (the
port's own; the JAX package has no counterpart).

As torchrec's ``DLRM_DCN`` computes it (Naumov et al., arXiv:1906.00091;
the cross of Wang et al., arXiv:2008.13535): the dense values go through
the bottom MLP, ReLU after every layer, to one ``E``-wide row; that row and
the ``N`` pooled embedding bags, flattened, are ``x0`` (``(N + 1) * E``
wide); a low-rank cross network
(:class:`~torecsys_tpu_torch.layers.ctr.cross.LowRankCrossNetworkLayer`)
follows, then the top MLP, ReLU after each hidden layer, to one raw score.
Under ``set_compute_dtype("bfloat16")`` the MLPs' and the cross's products
run in bf16 and ``x0``, the cross's combine and the score in float32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from torecsys_tpu_torch.layers.ctr import LowRankCrossNetworkLayer, MultilayerPerceptionLayer
from torecsys_tpu_torch.models.base import CtrBaseModel, input_shape, register_model
from torecsys_tpu_torch.utils import DeviceLike, resolve_device


@register_model("DLRM_DCNv2", "DLRMDCNv2")
class DLRMDCNv2Model(CtrBaseModel):
    """``feat_inputs`` ``(B, D[, 1])`` and ``emb_inputs`` ``(B, N, E)`` →
    ``(B, 1)`` float32 scores.  ``bottom`` maps ``D`` through
    ``bottom_layer_sizes`` to ``E``; ``cross`` takes ``cross_num_layers``
    steps at ``cross_rank``; ``top`` maps ``(N + 1) * E`` through
    ``top_layer_sizes`` to 1.  The defaults are MLPerf's."""

    def __init__(self, feat_size: int, num_fields: int, embed_size: int,
                 bottom_layer_sizes: Sequence[int] = (512, 256), cross_num_layers: int = 3,
                 cross_rank: int = 512, top_layer_sizes: Sequence[int] = (1024, 1024, 512, 256),
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        width = (num_fields + 1) * embed_size
        self.bottom = MultilayerPerceptionLayer(feat_size, embed_size,
                                                layer_sizes=tuple(bottom_layer_sizes),
                                                device=dev, generator=generator)
        self.cross = LowRankCrossNetworkLayer(cross_num_layers, width, cross_rank, device=dev,
                                              generator=generator)
        self.top = MultilayerPerceptionLayer(width, 1, layer_sizes=tuple(top_layer_sizes),
                                             device=dev, generator=generator)

    @classmethod
    def from_inputs(cls, inputs, **kwargs):
        n, e = input_shape(inputs, "emb_inputs")
        kwargs.setdefault("feat_size", math.prod(input_shape(inputs, "feat_inputs")))
        kwargs.setdefault("num_fields", n)
        kwargs.setdefault("embed_size", e)
        return cls(**kwargs)

    def forward(self, feat_inputs: torch.Tensor, emb_inputs: torch.Tensor) -> torch.Tensor:
        b = emb_inputs.shape[0]
        bottom = torch.relu(self.bottom(feat_inputs.reshape(b, -1)))
        x0 = torch.cat([bottom.to(emb_inputs.dtype), emb_inputs.reshape(b, -1)], dim=1)
        return self.top(self.cross(x0)).float()


__all__ = ["DLRMDCNv2Model"]
