"""Session-interest and position-bias models (counterpart of
``torecsys_tpu/models/ctr/session.py``): DSIN and PAL.

PAL wraps any pCTR model, ``pctr_model``, whose inputs come in as one
dict: in a ``Sequential`` that is a nested ``Inputs`` under
``pctr_inputs``, beside the ``(B,)`` position ids under ``pos_inputs``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from torecsys_tpu_torch.layers.ctr import (
    BiasEncodingLayer,
    Dense,
    MultiHeadDotProductAttention,
    MultilayerPerceptionLayer,
    PositionBiasAwareLearningFrameworkLayer,
)
from torecsys_tpu_torch.layers.rnn import RNN, Bidirectional, OptimizedLSTMCell
from torecsys_tpu_torch.models.base import CtrBaseModel, get_model, register_model
from torecsys_tpu_torch.utils import DeviceLike, default_generator, resolve_device
from torecsys_tpu_torch.utils.decorator import in_development


@register_model("DSIN", "DeepSessionInterestNetwork")
@in_development(
    "the reference marks DSIN '[in development]' with no output head; this port "
    "adds an optional head (use_output_head) but keeps the status marker")
class DeepSessionInterestNetworkModel(CtrBaseModel):
    """DSIN over session behaviour embeddings, ``forward(session_embed_inputs
    (B, L, E), session_index (B,)) → (B, 1)``, or the ``(B, E + 2H)``
    features with ``use_output_head=False``:

    * ``bias_encoding`` (:class:`BiasEncodingLayer`, with
      ``use_bias_encoding``): the session, position and unit biases;
    * ``interest_extractor``: multi-head self-attention (``qkv_features =
      E``), under the pipeline's compute dtype (the JAX package's
      ``mha_dtype()``);
    * the interest interaction: a :class:`Bidirectional` pair of flax's
      ``OptimizedLSTMCell`` of ``interacting_hidden_size`` (H) features over
      all L steps, without lengths, as the JAX package runs it; the cells
      keep flax's names in this module's scope, ``OptimizedLSTMCell_0``
      (forward) and ``OptimizedLSTMCell_1`` (backward), and compute in
      float32;
    * the means over L of both, concatenated, and ``output_head``, a
      :class:`Dense` to 1 under the pipeline's compute dtype.

    Building it warns a ``FutureWarning`` (``in_development``), as the JAX
    package's does.
    """

    def __init__(self, embed_size: int, max_num_session: int, max_num_position: int,
                 extractor_num_heads: int = 1, interacting_hidden_size: int = 16,
                 extractor_dropout: float = 0.0, use_bias_encoding: bool = True,
                 use_output_head: bool = True, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        e, h = embed_size, interacting_hidden_size
        self.bias_encoding = (BiasEncodingLayer(max_num_session, max_num_position, e, device=dev)
                              if use_bias_encoding else None)
        self.interest_extractor = MultiHeadDotProductAttention(
            e, extractor_num_heads, qkv_features=e, dropout_rate=extractor_dropout, device=dev)
        self.OptimizedLSTMCell_0 = OptimizedLSTMCell(e, h, device=dev)
        self.OptimizedLSTMCell_1 = OptimizedLSTMCell(e, h, device=dev)
        self.output_head = Dense(e + 2 * h, 1, device=dev) if use_output_head else None
        self.reset_parameters(default_generator(dev, generator=generator))

    @classmethod
    def from_inputs(cls, inputs, **kwargs):
        """``embed_size`` defaults to the ``session_embed_inputs``' E."""
        if "session_embed_inputs" in inputs.schema:
            kwargs.setdefault("embed_size", inputs.schema["session_embed_inputs"].embed_size)
        return cls(**kwargs)

    def reset_parameters(self, generator=None) -> None:
        for m in (self.bias_encoding, self.interest_extractor, self.OptimizedLSTMCell_0,
                  self.OptimizedLSTMCell_1, self.output_head):
            if m is not None:
                m.reset_parameters(generator)

    def forward(self, session_embed_inputs: torch.Tensor,
                session_index: torch.Tensor) -> torch.Tensor:
        x = session_embed_inputs
        if self.bias_encoding is not None:
            x = self.bias_encoding(x, session_index)
        extraction = self.interest_extractor(x)  # (B, L, E), in the compute dtype
        interaction = Bidirectional(RNN(self.OptimizedLSTMCell_0),
                                    RNN(self.OptimizedLSTMCell_1))(extraction)  # (B, L, 2H)
        # jnp.mean: a float32 sum over L divided, rounded once to the dtype
        pooled_extraction = extraction.float().mean(dim=1).to(extraction.dtype)
        features = torch.cat([pooled_extraction.float(), interaction.mean(dim=1)], dim=1)
        if self.output_head is None:
            return features
        return self.output_head(features)


@register_model("PAL", "PositionBiasAwareLearningFramework")
class PositionBiasAwareLearningFrameworkModel(CtrBaseModel):
    """The pCTR model's output, plus its position's bias (``pos_embedding``,
    a ``(max_num_position, output_size)`` table), through the ``pos_dense``
    MLP to 1 and a sigmoid: ``forward(pctr_inputs: dict, pos_inputs (B,))
    → (B, 1)`` probabilities.  :meth:`predict` runs the wrapped model alone
    (the position branch dropped), as the JAX package's; the Trainer's
    ``predict`` runs the eval step over ``forward``, as the JAX Trainer's
    does."""

    outputs_probability = True

    def __init__(self, pctr_model: nn.Module, output_size: int = 1, max_num_position: int = 128,
                 pos_layer_sizes: Sequence[int] = (16,), pos_dropout_rate: float = 0.0,
                 activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.pctr_model = pctr_model.to(dev)
        self.pos_embedding = PositionBiasAwareLearningFrameworkLayer(
            output_size, max_num_position, device=dev)
        self.pos_dense = MultilayerPerceptionLayer(
            output_size, 1, layer_sizes=tuple(pos_layer_sizes), dropout_rate=pos_dropout_rate,
            activation=activation, device=dev)
        self.reset_parameters(default_generator(dev, generator=generator))

    @classmethod
    def from_inputs(cls, inputs, pctr_model, pctr_kwargs: Optional[Dict] = None, **kwargs):
        """``pctr_model`` an instance, or a registry name built with
        ``pctr_kwargs`` from the nested ``Inputs`` under ``pctr_inputs``."""
        if not isinstance(pctr_model, nn.Module):
            pctr_model = get_model(pctr_model, inputs=inputs.schema["pctr_inputs"],
                                   device=kwargs.get("device"), **(pctr_kwargs or {}))
        return cls(pctr_model, **kwargs)

    def forward(self, pctr_inputs: Dict[str, torch.Tensor],
                pos_inputs: torch.Tensor) -> torch.Tensor:
        pos = self.pos_embedding(self.pctr_model(**pctr_inputs), pos_inputs)
        return torch.sigmoid(self.pos_dense(pos))

    def predict(self, pctr_inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The inference path: the pCTR model alone."""
        return self.pctr_model(**pctr_inputs)


DSIN = DeepSessionInterestNetworkModel
PAL = PositionBiasAwareLearningFrameworkModel

__all__ = ["DSIN", "DeepSessionInterestNetworkModel", "PAL",
           "PositionBiasAwareLearningFrameworkModel"]
