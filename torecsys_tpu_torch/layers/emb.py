"""Embedding-model layers (counterpart of ``torecsys_tpu/layers/emb.py``):
generalized matrix factorization and StarSpace."""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from torecsys_tpu_torch.utils.operations import inner_product_similarity


class GeneralizedMatrixFactorizationLayer(nn.Module):
    """Dot product of the user and the item rows: ``(B, 2, E) → (B, 1)``."""

    def forward(self, emb_inputs: torch.Tensor) -> torch.Tensor:
        return torch.sum(emb_inputs[:, 0, :] * emb_inputs[:, 1, :], dim=-1, keepdim=True)


class StarSpaceLayer(nn.Module):
    """The similarity of the context and the target rows of ``(B, 2, E)``,
    taken over the ``(B, 1, E)`` slices' axis 1: ``(B, E)`` with the inner
    product (its per-dimension terms)."""

    def __init__(self, similarity: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
                 = inner_product_similarity):
        super().__init__()
        self.similarity = similarity

    def forward(self, samples_inputs: torch.Tensor) -> torch.Tensor:
        return self.similarity(samples_inputs[:, 0:1, :], samples_inputs[:, 1:2, :])


__all__ = ["GeneralizedMatrixFactorizationLayer", "StarSpaceLayer"]
