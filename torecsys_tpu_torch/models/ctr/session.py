"""Position-bias and session models (counterpart of
``torecsys_tpu/models/ctr/session.py``): PAL, and DSIN's place in the
registry.

PAL wraps any pCTR model, ``pctr_model``, whose inputs come in as one
dict: in a ``Sequential`` that is a nested ``Inputs`` under
``pctr_inputs``, beside the ``(B,)`` position ids under ``pos_inputs``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from torecsys_tpu_torch.layers.ctr import (
    MultilayerPerceptionLayer,
    PositionBiasAwareLearningFrameworkLayer,
)
from torecsys_tpu_torch.models.base import CtrBaseModel, get_model, register_model
from torecsys_tpu_torch.utils import DeviceLike, default_generator, resolve_device


@register_model("DSIN", "DeepSessionInterestNetwork")
class DeepSessionInterestNetworkModel(CtrBaseModel):
    """DSIN, not ported yet: its interest interaction is flax's
    bidirectional LSTM, which comes with the sequence inputs."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "DSIN (DeepSessionInterestNetworkModel) is not ported yet (ROADMAP queue 1: "
            "Sequence inputs and DSIN, with flax's LSTM cells; its BiasEncodingLayer and "
            "multi-head attention are ported)")

    @classmethod
    def from_inputs(cls, inputs, **kwargs):
        return cls(**kwargs)


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
