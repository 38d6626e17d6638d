"""Functional ranking and regression metrics (counterpart of
``torecsys_tpu/metrics/functional.py``) on fixed-shape tensors: an id below
0 is a pad slot and matches nothing."""

from __future__ import annotations

from typing import Optional

import torch


def mse(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    """Mean squared error."""
    return torch.mean(torch.square(y_pred - y_true))


def _hits(rec_ids: torch.Tensor, rel_ids: torch.Tensor) -> torch.Tensor:
    """``(B, K) x (B, R) → (B, K)`` float32: 1 where a recommended id is
    relevant."""
    eq = rec_ids[:, :, None] == rel_ids[:, None, :]
    valid = (rec_ids >= 0)[:, :, None] & (rel_ids >= 0)[:, None, :]
    return torch.any(eq & valid, dim=-1).to(torch.float32)


def _num_relevant(rel_ids: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(torch.sum((rel_ids >= 0).to(torch.float32), dim=1), 1.0)


def mean_average_precision_at_k(rec_ids: torch.Tensor, rel_ids: torch.Tensor,
                                k: int) -> torch.Tensor:
    """MAP@k of ``(B, >=k)`` recommended ids, best first, against ``(B, R)``
    relevant ids (both ``-1`` padded; lists de-duplicated)."""
    hits = _hits(rec_ids[:, :k], rel_ids)
    ranks = torch.arange(1, hits.shape[1] + 1, dtype=torch.float32, device=hits.device)[None, :]
    precision_at_i = torch.cumsum(hits, dim=1) / ranks
    ap = torch.sum(precision_at_i * hits, dim=1) / torch.clamp_max(_num_relevant(rel_ids),
                                                                    float(k))
    return torch.mean(ap)


def mean_average_recall_at_k(rec_ids: torch.Tensor, rel_ids: torch.Tensor,
                             k: int) -> torch.Tensor:
    """MAR@k: the mean share of each row's relevant ids among its first k."""
    hits = _hits(rec_ids[:, :k], rel_ids)
    return torch.mean(torch.sum(hits, dim=1) / _num_relevant(rel_ids))


def discounted_cumulative_gain(relevance: torch.Tensor, k: Optional[int] = None,
                               exp: bool = True) -> torch.Tensor:
    """DCG@k per ``(B, L)`` list in rank order: ``Σ gain_i / log2(i + 2)``,
    gains ``2^rel - 1`` (``exp``) or ``rel``."""
    if k is not None:
        relevance = relevance[:, :k]
    gains = torch.exp2(relevance) - 1.0 if exp else relevance
    positions = torch.arange(2, relevance.shape[1] + 2, dtype=torch.float32,
                             device=relevance.device)
    return torch.sum(gains * (1.0 / torch.log2(positions))[None, :], dim=1)


def ideal_discounted_cumulative_gain(relevance: torch.Tensor, k: Optional[int] = None,
                                     exp: bool = True) -> torch.Tensor:
    """IDCG@k: the DCG of each list sorted by descending relevance."""
    ideal = torch.sort(relevance, dim=1, descending=True).values
    return discounted_cumulative_gain(ideal, k=k, exp=exp)


def normalized_discounted_cumulative_gain(relevance: torch.Tensor, k: Optional[int] = None,
                                          exp: bool = True) -> torch.Tensor:
    """NDCG@k averaged over the batch."""
    dcg = discounted_cumulative_gain(relevance, k=k, exp=exp)
    idcg = ideal_discounted_cumulative_gain(relevance, k=k, exp=exp)
    return torch.mean(dcg / torch.clamp_min(idcg, 1e-12))


def self_information(rec_ids: torch.Tensor, occurrence: torch.Tensor, num_users: int):
    """(``-log2(occurrence / num_users)`` of each recommended id, 1 where
    the id is not a pad slot), both ``(B, K)`` float32."""
    occ = torch.take(occurrence, torch.clamp_min(rec_ids, 0).to(torch.int64))
    p = torch.clamp(occ.to(torch.float32) / float(num_users), 1e-12, 1.0)
    return -torch.log2(p), (rec_ids >= 0).to(torch.float32)


def novelty_score(rec_ids: torch.Tensor, occurrence: torch.Tensor,
                  num_users: int) -> torch.Tensor:
    """Mean self-information of the recommended items (``-1`` pads left
    out): ``rec_ids`` ``(B, K)``, ``occurrence`` ``(V,)`` counts."""
    info, valid = self_information(rec_ids, occurrence, num_users)
    return torch.sum(info * valid) / torch.clamp_min(torch.sum(valid), 1.0)


__all__ = [
    "discounted_cumulative_gain", "ideal_discounted_cumulative_gain",
    "mean_average_precision_at_k", "mean_average_recall_at_k", "mse",
    "normalized_discounted_cumulative_gain", "novelty_score", "self_information",
]
