"""Factorization-machine layer (counterpart of
``torecsys_tpu/layers/ctr/factorization.py``)."""

from __future__ import annotations

import torch
from torch import nn

from torecsys_tpu_torch.ops.interactions import fm_pairwise_interaction


class FactorizationMachineLayer(nn.Module):
    """FM second-order interaction ``0.5·((Σv)² − Σv²)``, ``(B, N, E) → (B, E)``."""

    def __init__(self, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout = nn.Dropout(dropout_rate) if dropout_rate > 0 else None

    def forward(self, emb_inputs: torch.Tensor) -> torch.Tensor:
        out = fm_pairwise_interaction(emb_inputs)
        if self.dropout is not None:
            out = self.dropout(out)
        return out
