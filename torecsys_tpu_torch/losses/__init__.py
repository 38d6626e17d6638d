"""Losses (counterpart of ``torecsys_tpu/losses``): the pointwise CTR
criteria, the learning-to-rank losses and the embedding loss.

A loss is a frozen dataclass over the functions of
:mod:`torecsys_tpu_torch.losses.functional`.  The ranking losses take
``(pos, neg, mask=None)``, but :class:`ListnetLoss`, whose
``groupwise = True`` makes the ``ltr`` train step hand it per-anchor
``[pos | negs]`` lists with one-hot relevance, ``(y_true, y_pred)``.
:data:`LOSSES` resolves the JAX package's names.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Type

import torch

from torecsys_tpu_torch.losses import functional as F
from torecsys_tpu_torch.losses.functional import align_targets, binary_cross_entropy_with_logits
from torecsys_tpu_torch.utils import get_reduction


def _reduce(loss: torch.Tensor, reduction, mask) -> torch.Tensor:
    """A mask's weighted mean, or else ``reduction`` resolved by
    :func:`~torecsys_tpu_torch.utils.get_reduction`."""
    if mask is not None:
        return F.apply_mask(loss, mask)
    return get_reduction(reduction)(loss)


class Loss:
    """Base loss.  Subclasses implement ``__call__`` returning a scalar."""


class RankingLoss(Loss):
    """Base of the ranking losses: ``loss(pos_outputs, neg_outputs, mask=None)``."""


class EmbLoss(Loss):
    """Base of the embedding losses."""


# ---- pointwise CTR criteria ------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BCEWithLogitsLoss(Loss):
    reduction: str = "mean"

    def __call__(self, preds, targets, mask=None):
        return _reduce(F.binary_cross_entropy_with_logits(preds, F.align_targets(preds, targets)),
                       self.reduction, mask)


@dataclasses.dataclass(frozen=True)
class BCELoss(Loss):
    reduction: str = "mean"

    def __call__(self, preds, targets, mask=None):
        return _reduce(F.binary_cross_entropy(preds, F.align_targets(preds, targets)),
                       self.reduction, mask)


@dataclasses.dataclass(frozen=True)
class MSELoss(Loss):
    reduction: str = "mean"

    def __call__(self, preds, targets, mask=None):
        return _reduce(F.mean_squared_error(preds, F.align_targets(preds, targets)),
                       self.reduction, mask)


# ---- learning to rank ------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PointwiseLogisticLoss(RankingLoss):
    def __call__(self, pos, neg, mask=None):
        return F.apply_mask(F.pointwise_logistic_ranking_loss(pos, neg), mask)


@dataclasses.dataclass(frozen=True)
class BayesianPersonalizedRankingLoss(RankingLoss):
    def __call__(self, pos, neg, mask=None):
        return F.apply_mask(F.bayesian_personalized_ranking_loss(pos, neg), mask)


@dataclasses.dataclass(frozen=True)
class HingeLoss(RankingLoss):
    margin: float = 1.0

    def __call__(self, pos, neg, mask=None):
        return F.apply_mask(F.hinge_loss(pos, neg, self.margin), mask)


@dataclasses.dataclass(frozen=True)
class AdaptiveHingeLoss(RankingLoss):
    """Hinge against each anchor's hardest negative."""

    margin: float = 1.0

    def __call__(self, pos, negs, mask=None):
        return F.apply_mask(F.adaptive_hinge_loss(pos, negs, self.margin), mask)


@dataclasses.dataclass(frozen=True)
class TripletLoss(RankingLoss):
    """Margin ranking, or soft margin when ``margin`` is None."""

    margin: Optional[float] = 1.0

    def __call__(self, pos, neg, mask=None):
        if self.margin is None:
            loss = F.soft_margin_loss(pos, neg)
        else:
            loss = F.margin_ranking_loss(pos, neg, self.margin)
        return F.apply_mask(loss, mask)


@dataclasses.dataclass(frozen=True)
class ListnetLoss(RankingLoss):
    """Groupwise ListNet top-1 cross entropy over ``(B, L)`` lists."""

    groupwise = True

    def __call__(self, y_true, y_pred, mask=None):
        return torch.mean(F.listnet_loss(y_true, y_pred, mask))


# ---- embedding -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SkipGramLoss(EmbLoss):
    def __call__(self, content, pos, negs, mask=None):
        return F.apply_mask(F.skip_gram_loss(content, pos, negs), mask)


LOSSES: Dict[str, Type[Loss]] = {
    "AdaptiveHingeLoss": AdaptiveHingeLoss,
    "BCELoss": BCELoss,
    "BCEWithLogitsLoss": BCEWithLogitsLoss,
    "BayesianPersonalizedRankingLoss": BayesianPersonalizedRankingLoss,
    "HingeLoss": HingeLoss,
    "ListnetLoss": ListnetLoss,
    "MSELoss": MSELoss,
    "PointwiseLogisticLoss": PointwiseLogisticLoss,
    "SkipGramLoss": SkipGramLoss,
    "TripletLoss": TripletLoss,
}


def get_loss(name_or_loss, **kwargs):
    """Resolve a loss by registry name or pass an instance through."""
    if not isinstance(name_or_loss, str):
        return name_or_loss
    if name_or_loss not in LOSSES:
        raise KeyError(f"unknown loss {name_or_loss!r}; available: {sorted(LOSSES)}")
    return LOSSES[name_or_loss](**kwargs)


__all__ = [
    "AdaptiveHingeLoss", "BCELoss", "BCEWithLogitsLoss", "BayesianPersonalizedRankingLoss",
    "EmbLoss", "HingeLoss", "LOSSES", "ListnetLoss", "Loss", "MSELoss", "PointwiseLogisticLoss",
    "RankingLoss", "SkipGramLoss", "TripletLoss", "align_targets",
    "binary_cross_entropy_with_logits", "functional", "get_loss",
]
