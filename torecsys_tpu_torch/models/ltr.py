"""Learning-to-rank models (counterpart of ``torecsys_tpu/models/ltr.py``):
the pairwise wrapper and PRM re-ranking."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from torecsys_tpu_torch.layers.ctr import (
    BatchNorm,
    Dense,
    MultiHeadDotProductAttention,
    PositionEmbeddingLayer,
)
from torecsys_tpu_torch.layers.precision import softmax
from torecsys_tpu_torch.models.base import LtrBaseModel, get_model, register_model
from torecsys_tpu_torch.utils import DeviceLike, default_generator, resolve_device


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
    """PRM: a transformer encoder over a ranked list → a softmax over the
    list, ``feat_inputs (B, L, E) → (B, L)``.

    The position embedding (``position_embedding``, optional), ``input_fc``
    (E → D), then for each of the ``num_encoder_layers`` blocks
    multi-head self-attention (``mha_{i}``), ``attn_bn_{i}(x + attn)``,
    ``ff1_{i}``, the activation, ``ff2_{i}`` and ``ff_bn_{i}(x + ff)``
    (post-norm residuals with flax's :class:`BatchNorm` over the feature
    axis, statistics over ``(B, L)``, running statistics as buffers), then
    ``output_fc`` (D → 1) and a softmax over L.  ``from_inputs`` reads
    ``embed_size`` and ``max_num_position`` off ``feat_inputs`` where the
    inputs give it.
    """

    def __init__(self, embed_size: int, max_num_position: int, encoding_size: int = 32,
                 num_encoder_layers: int = 2, num_heads: int = 2, ff_hidden_size: int = 64,
                 dropout_rate: float = 0.0, use_position_embedding: bool = True,
                 activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.num_encoder_layers = num_encoder_layers
        self.activation = activation
        self.position_embedding = (PositionEmbeddingLayer(max_num_position, device=dev)
                                   if use_position_embedding else None)
        d = encoding_size
        self.input_fc = Dense(embed_size, d, device=dev)
        for i in range(num_encoder_layers):
            self.add_module(f"mha_{i}", MultiHeadDotProductAttention(
                d, num_heads, qkv_features=d, dropout_rate=dropout_rate, device=dev))
            self.add_module(f"attn_bn_{i}", BatchNorm(d, axis=-1, device=dev))
            self.add_module(f"ff1_{i}", Dense(d, ff_hidden_size, device=dev))
            self.add_module(f"ff2_{i}", Dense(ff_hidden_size, d, device=dev))
            self.add_module(f"ff_bn_{i}", BatchNorm(d, axis=-1, device=dev))
        self.output_fc = Dense(d, 1, device=dev)
        self.reset_parameters(default_generator(dev, generator=generator))

    @classmethod
    def from_inputs(cls, inputs, **kwargs):
        if "feat_inputs" in inputs.schema:
            length, embed = inputs.schema["feat_inputs"].output_shape()
            kwargs.setdefault("embed_size", embed)
            kwargs.setdefault("max_num_position", length)
        return cls(**kwargs)

    def forward(self, feat_inputs: torch.Tensor) -> torch.Tensor:
        x = feat_inputs
        if self.position_embedding is not None:
            x = self.position_embedding(x)
        x = self.input_fc(x)  # (B, L, D)
        for i in range(self.num_encoder_layers):
            attn = getattr(self, f"mha_{i}")(x)
            x = getattr(self, f"attn_bn_{i}")(x + attn)
            ff = getattr(self, f"ff2_{i}")(self.activation(getattr(self, f"ff1_{i}")(x)))
            x = getattr(self, f"ff_bn_{i}")(x + ff)
        return softmax(self.output_fc(x)[..., 0], dim=-1)  # (B, L)


__all__ = ["LearningToRankWrapper", "PersonalizedReRankingModel"]
