"""Embedding-model layers (counterpart of ``torecsys_tpu/layers/emb.py``):
generalized matrix factorization.  ``StarSpaceLayer`` is not ported yet."""

from __future__ import annotations

import torch
from torch import nn


class GeneralizedMatrixFactorizationLayer(nn.Module):
    """Dot product of the user and the item rows: ``(B, 2, E) → (B, 1)``."""

    def forward(self, emb_inputs: torch.Tensor) -> torch.Tensor:
        return torch.sum(emb_inputs[:, 0, :] * emb_inputs[:, 1, :], dim=-1, keepdim=True)


__all__ = ["GeneralizedMatrixFactorizationLayer"]
