"""Learning-to-rank models (counterpart of ``torecsys_tpu/models/ltr.py``):
the pairwise wrapper.  PRM waits for its attention layers."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from torecsys_tpu_torch.models.base import LtrBaseModel, get_model, register_model


@register_model("LTRWrapper")
class LearningToRankWrapper(LtrBaseModel):
    """Runs the wrapped scoring model on a positive and a negative input
    dict: ``forward(pos_inputs, neg_inputs) → {"pos_outputs": ...,
    "neg_outputs": ...}``; :meth:`predict` scores one input dict.  The
    wrapped model's parameters are named under ``model``, as the JAX
    package's."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    @classmethod
    def from_inputs(cls, inputs, model, **kwargs):
        """``model`` an instance, or a registry name built from ``inputs``
        with ``kwargs``."""
        if not isinstance(model, nn.Module):
            model = get_model(model, inputs=inputs, **kwargs)
        return cls(model)

    def forward(self, pos_inputs: Dict[str, torch.Tensor],
                neg_inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"pos_outputs": self.model(**pos_inputs), "neg_outputs": self.model(**neg_inputs)}

    def predict(self, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.model(**inputs)


@register_model("PRM", "PersonalizedReRanking")
class PersonalizedReRankingModel(LtrBaseModel):
    """PRM, not ported yet: it needs ``PositionEmbeddingLayer`` and
    multi-head attention, which come with the attention slice."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "PRM (PersonalizedReRankingModel) is not ported yet (ROADMAP queue 1 item 8: the "
            "attention slice, layers/ctr/attention.py with PositionEmbeddingLayer and "
            "multi-head attention)")


__all__ = ["LearningToRankWrapper", "PersonalizedReRankingModel"]
