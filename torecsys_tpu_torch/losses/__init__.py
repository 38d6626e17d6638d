"""Losses (counterpart of ``torecsys_tpu/losses``): the pointwise CTR
criterion of the main path."""

from __future__ import annotations

import dataclasses
from typing import Dict, Type

import torch


def align_targets(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Reshape ``(B,)`` targets against ``(B, 1)`` predictions (and the
    reverse) so elementwise losses never silently broadcast ``(B, B)``."""
    if targets.shape != preds.shape and targets.numel() == preds.numel():
        return targets.reshape(preds.shape)
    return targets


def binary_cross_entropy_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable per-example BCE on logits, written as the JAX
    package writes it."""
    targets = targets.to(logits.dtype)
    return torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))


_REDUCTIONS = {"mean": torch.mean, "sum": torch.sum, "none": lambda x: x}


class Loss:
    """Base loss.  Subclasses implement ``__call__`` returning a scalar."""


@dataclasses.dataclass(frozen=True)
class BCEWithLogitsLoss(Loss):
    reduction: str = "mean"

    def __call__(self, preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        loss = binary_cross_entropy_with_logits(preds, align_targets(preds, targets))
        return _REDUCTIONS[self.reduction](loss)


LOSSES: Dict[str, Type[Loss]] = {"BCEWithLogitsLoss": BCEWithLogitsLoss}


def get_loss(name_or_loss, **kwargs):
    """Resolve a loss by registry name or pass an instance through."""
    if not isinstance(name_or_loss, str):
        return name_or_loss
    if name_or_loss not in LOSSES:
        raise KeyError(f"unknown loss {name_or_loss!r}; available: {sorted(LOSSES)}")
    return LOSSES[name_or_loss](**kwargs)


__all__ = ["BCEWithLogitsLoss", "LOSSES", "Loss", "align_targets",
           "binary_cross_entropy_with_logits", "get_loss"]
