"""Factorization-style interaction layers: FM, FFM and AFM (counterpart of
``torecsys_tpu/layers/ctr/factorization.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from torecsys_tpu_torch.layers.ctr.dense import Dense
from torecsys_tpu_torch.ops.interactions import (
    afm_pairwise_products,
    ffm_pairwise_interaction,
    fm_pairwise_interaction,
)
from torecsys_tpu_torch.utils import DeviceLike


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


class FieldAwareFactorizationMachineLayer(nn.Module):
    """FFM interaction ``e_{i,f_j} ⊙ e_{j,f_i}`` for all i<j:
    ``(B, N*N, E) → (B, C(N,2), E)``."""

    def __init__(self, num_fields: int, dropout_rate: float = 0.0):
        super().__init__()
        self.num_fields = num_fields
        self.dropout = nn.Dropout(dropout_rate) if dropout_rate > 0 else None

    def forward(self, field_emb_inputs: torch.Tensor) -> torch.Tensor:
        out = ffm_pairwise_interaction(field_emb_inputs, self.num_fields)
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class AttentionalFactorizationMachineLayer(nn.Module):
    """AFM: the attention-weighted sum of the pairwise Hadamard products,
    ``(B, N, E) → ((B, E), (B, C(N,2), 1))``: the pooled interaction and the
    attention scores.  The attention is ``attn_w`` (E → attn_size), ReLU,
    ``attn_h`` (→ 1) and a softmax over the pairs, in the products'
    ``compute_dtype`` as the JAX package's precision ``Dense`` computes them.
    """

    def __init__(self, embed_size: int, attn_size: int, dropout_rate: float = 0.0,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.attn_w = Dense(embed_size, attn_size, device=device, generator=generator)
        self.attn_h = Dense(attn_size, 1, device=device, generator=generator)
        self.dropout = nn.Dropout(dropout_rate) if dropout_rate > 0 else None

    def reset_parameters(self, generator=None) -> None:
        self.attn_w.reset_parameters(generator)
        self.attn_h.reset_parameters(generator)

    def forward(self, emb_inputs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        products = afm_pairwise_products(emb_inputs)  # (B, P, E)
        scores = self.attn_h(torch.relu(self.attn_w(products)))  # (B, P, 1)
        attn = torch.softmax(scores, dim=1)
        if self.dropout is not None:
            attn = self.dropout(attn)
        out = torch.sum(attn * products, dim=1)  # (B, E)
        if self.dropout is not None:
            out = self.dropout(out)
        return out, attn


__all__ = ["AttentionalFactorizationMachineLayer", "FactorizationMachineLayer",
           "FieldAwareFactorizationMachineLayer"]
