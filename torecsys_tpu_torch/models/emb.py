"""Embedding models (counterpart of ``torecsys_tpu/models/emb.py``): matrix
factorization and StarSpace."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from torecsys_tpu_torch.layers.emb import GeneralizedMatrixFactorizationLayer, StarSpaceLayer
from torecsys_tpu_torch.models.base import EmbBaseModel, input_shape, register_model
from torecsys_tpu_torch.utils import DeviceLike
from torecsys_tpu_torch.utils.operations import inner_product_similarity


@register_model("MF", "MatrixFactorization")
class MatrixFactorizationModel(EmbBaseModel):
    """The dot product of the ``(B, 2, E)`` user and item rows → ``(B, 1)``.
    It has no parameters of its own: the table is the model (``device`` and
    ``generator`` are accepted as every model's)."""

    def __init__(self, device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        del device, generator
        super().__init__()
        self.mf = GeneralizedMatrixFactorizationLayer()

    @classmethod
    def from_inputs(cls, inputs, **kwargs):
        n, _ = input_shape(inputs, "emb_inputs")
        if n != 2:
            raise ValueError(f"MF takes the (B, 2, E) user and item rows, got {n} rows")
        return cls(**kwargs)

    def forward(self, emb_inputs: torch.Tensor) -> torch.Tensor:
        return self.mf(emb_inputs)


@register_model("StarSpace")
class StarSpaceModel(EmbBaseModel):
    """StarSpace over the miner's aggregated batch: ``context_inputs`` and
    ``target_inputs`` ``(B·(1+num_neg), 1, E)`` in per-anchor blocks
    ``[pos, neg_1, ..., neg_num_neg]`` (``train.steps.interleave_pos_neg``)
    → ``(B·(1+num_neg), 1)`` similarity scores, the positive first in each
    block.  :meth:`predict` scores a plain (context, target) pair.  It has
    no parameters of its own."""

    def __init__(self, embed_size: int, num_neg: int,
                 similarity: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
                 = inner_product_similarity, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        del device, generator
        super().__init__()
        self.embed_size = int(embed_size)
        self.num_neg = int(num_neg)
        self.starspace = StarSpaceLayer(similarity)

    @classmethod
    def from_inputs(cls, inputs, **kwargs):
        for name in ("context_inputs", "target_inputs"):
            n, e = input_shape(inputs, name)
            if n != 1:
                raise ValueError(f"StarSpace takes (B, 1, E) {name}, got {n} rows")
        kwargs.setdefault("embed_size", e)
        return cls(**kwargs)

    def _score(self, context: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """``(n, 1, E)`` × 2 → ``(n,)``: the layer's per-dimension terms summed."""
        sim = self.starspace(torch.cat([context, target], dim=1))
        return sim.reshape(context.shape[0], -1).sum(dim=1)

    def forward(self, context_inputs: torch.Tensor, target_inputs: torch.Tensor) -> torch.Tensor:
        agg_b, k, e = context_inputs.shape[0], self.num_neg, self.embed_size
        b = agg_b // (1 + k)
        context = context_inputs.reshape(b, 1 + k, e)
        target = target_inputs.reshape(b, 1 + k, e)
        pos = self._score(context[:, 0:1, :], target[:, 0:1, :]).reshape(b, 1)
        neg = self._score(context[:, 1:, :].reshape(b * k, 1, e),
                          target[:, 1:, :].reshape(b * k, 1, e)).reshape(b, k)
        return torch.cat([pos, neg], dim=1).reshape(agg_b, 1)

    def predict(self, context_inputs: torch.Tensor, target_inputs: torch.Tensor) -> torch.Tensor:
        """Score a plain (context, target) pair: ``(B, 1, E)`` × 2 → ``(B, 1)``."""
        return self._score(context_inputs, target_inputs)[:, None]


__all__ = ["MatrixFactorizationModel", "StarSpaceModel"]
