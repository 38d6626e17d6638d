"""Interaction primitives (counterpart of ``torecsys_tpu/ops/interactions.py``)."""

from __future__ import annotations

import torch


def fm_pairwise_interaction(emb_inputs: torch.Tensor) -> torch.Tensor:
    """Factorization-machine second-order interaction over the field axis:
    ``0.5 * ((sum_n v_n)^2 - sum_n v_n^2)``, ``(B, N, E) → (B, E)``."""
    sum_sq = torch.square(torch.sum(emb_inputs, dim=1))
    sq_sum = torch.sum(torch.square(emb_inputs), dim=1)
    return 0.5 * (sum_sq - sq_sum)


__all__ = ["fm_pairwise_interaction"]
