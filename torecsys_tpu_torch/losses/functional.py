"""Functional losses (counterpart of ``torecsys_tpu/losses/functional.py``).

Every function takes raw tensors and returns per-example losses; reduction
and masking are applied by the loss classes in
:mod:`torecsys_tpu_torch.losses`.  Each is written as the JAX package writes
it, and where JAX's gradient has a rule at a tie the torch op with the same
rule is taken: ``torch.maximum`` and ``torch.amax`` split the gradient
evenly among tied arguments as ``jnp.maximum`` and ``jnp.max`` do, and
``softplus`` has gradient 1/2 at 0 as ``jax.nn.softplus`` has.  An
in-batch miner draws the anchor's own target now and then, so a pairwise
loss meets ``pos == neg`` exactly.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def apply_mask(loss: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Masked mean: the mean of ``loss`` over the rows where ``mask`` is
    true; with no mask, the plain mean."""
    if mask is None:
        return torch.mean(loss)
    m = mask.to(loss.dtype)
    while m.dim() < loss.dim():
        m = m[..., None]
    denom = torch.clamp_min(torch.sum(m), 1.0)
    return torch.sum(loss * m) / denom


def align_targets(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Reshape ``(B,)`` targets against ``(B, 1)`` predictions (and the
    reverse) so elementwise losses never silently broadcast ``(B, B)``."""
    if targets.shape != preds.shape and targets.numel() == preds.numel():
        return targets.reshape(preds.shape)
    return targets


# ---- pointwise CTR criteria ------------------------------------------------

def binary_cross_entropy_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable per-example BCE on logits, written as the JAX
    package writes it."""
    targets = targets.to(logits.dtype)
    return torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))


def binary_cross_entropy(probs: torch.Tensor, targets: torch.Tensor,
                         eps: float = 1e-7) -> torch.Tensor:
    """Per-example BCE on probabilities, clipped to ``[eps, 1 - eps]``."""
    p = torch.clamp(probs, eps, 1.0 - eps)
    targets = targets.to(p.dtype)
    return -(targets * torch.log(p) + (1.0 - targets) * torch.log(1.0 - p))


def mean_squared_error(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-example squared error."""
    return torch.square(preds - targets.to(preds.dtype))


# ---- learning-to-rank ------------------------------------------------------

def pointwise_logistic_ranking_loss(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """``(1 - σ(pos)) + σ(neg)``."""
    return (1.0 - torch.sigmoid(pos)) + torch.sigmoid(neg)


def bayesian_personalized_ranking_loss(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """BPR, ``-log σ(pos - neg)``, as ``softplus(neg - pos)``."""
    return F.softplus(neg - pos)


def hinge_loss(pos: torch.Tensor, neg: torch.Tensor, margin: float = 1.0) -> torch.Tensor:
    """``max(0, margin - pos + neg)``."""
    x = margin - pos + neg
    return torch.maximum(torch.zeros_like(x), x)


def adaptive_hinge_loss(pos: torch.Tensor, negs: torch.Tensor, margin: float = 1.0) -> torch.Tensor:
    """Hinge against the hardest of each row's ``K`` negatives: ``pos``
    ``(B, 1)``, ``negs`` ``(B, K)``."""
    return hinge_loss(pos, torch.amax(negs, dim=-1, keepdim=True), margin)


def margin_ranking_loss(pos: torch.Tensor, neg: torch.Tensor, margin: float = 1.0) -> torch.Tensor:
    """``max(0, margin - (pos - neg))``: torch's ``MarginRankingLoss`` with
    target 1."""
    x = margin - (pos - neg)
    return torch.maximum(torch.zeros_like(x), x)


def soft_margin_loss(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(-(pos - neg)))``: torch's ``SoftMarginLoss`` with
    target 1."""
    return F.softplus(-(pos - neg))


def listnet_loss(y_true: torch.Tensor, y_pred: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ListNet top-1 cross entropy ``-Σ softmax(y)·log softmax(ŷ)`` per
    ``(B, L)`` list; masked positions are filled with ``-1e9`` before the
    softmaxes and take no part in the sum."""
    if mask is not None:
        mask = mask.to(torch.bool)
        y_true = torch.where(mask, y_true, torch.full_like(y_true, -1e9))
        y_pred = torch.where(mask, y_pred, torch.full_like(y_pred, -1e9))
    p_true = torch.softmax(y_true, dim=-1)
    logp = torch.log_softmax(y_pred, dim=-1)
    if mask is not None:
        logp = torch.where(mask, logp, torch.zeros_like(logp))
        p_true = torch.where(mask, p_true, torch.zeros_like(p_true))
    return -torch.sum(p_true * logp, dim=-1)


# ---- embedding -------------------------------------------------------------

def skip_gram_loss(content: torch.Tensor, pos: torch.Tensor, negs: torch.Tensor) -> torch.Tensor:
    """Skip-gram negative sampling ``-(log σ(c·p) + Σ log σ(-c·n))``:
    ``content`` and ``pos`` ``(B, E)``, ``negs`` ``(B, K, E)``."""
    pos_score = torch.sum(content * pos, dim=-1)
    neg_score = torch.einsum("be,bke->bk", content, negs)
    return -(F.logsigmoid(pos_score) + torch.sum(F.logsigmoid(-neg_score), dim=-1))


__all__ = [
    "adaptive_hinge_loss", "align_targets", "apply_mask", "bayesian_personalized_ranking_loss",
    "binary_cross_entropy", "binary_cross_entropy_with_logits", "hinge_loss", "listnet_loss",
    "margin_ranking_loss", "mean_squared_error", "pointwise_logistic_ranking_loss",
    "skip_gram_loss", "soft_margin_loss",
]
