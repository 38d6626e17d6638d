"""Inputs layer: the embedding front-end.

Counterpart of ``torecsys_tpu/inputs/__init__.py``: routes raw batch fields
through input modules per a declarative schema and emits a dict keyed by
model-argument name, so that ``model(**inputs(batch))``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn

from torecsys_tpu_torch.inputs.base import BaseInput, Batch
from torecsys_tpu_torch.inputs.embeddings import (
    ConcatInput,
    MultiHotIndicesEmbedding,
    MultiIndicesEmbedding,
    MultiIndicesFieldAwareEmbedding,
    SingleIndexEmbedding,
    StackedInput,
    TableInput,
    ValueInput,
)
from torecsys_tpu_torch.inputs.image import ImageInput, PretrainedImageInput, save_tower_weights
from torecsys_tpu_torch.inputs.sequence import ListIndicesEmbedding, SequenceIndicesEmbedding


class Inputs(nn.Module):
    """Schema-driven wrapper: ``{model_arg_name: input_module}``."""

    def __init__(self, schema: Mapping[str, BaseInput]):
        super().__init__()
        self.schema = nn.ModuleDict(dict(schema))

    def forward(self, batch: Batch) -> Dict[str, torch.Tensor]:
        return {name: module(batch) for name, module in self.schema.items()}

    def reset_parameters(self, generator=None) -> None:
        for module in self.schema.values():
            module.reset_parameters(generator)


__all__ = ["BaseInput", "ConcatInput", "ImageInput", "Inputs", "ListIndicesEmbedding",
           "MultiHotIndicesEmbedding", "MultiIndicesEmbedding", "MultiIndicesFieldAwareEmbedding",
           "PretrainedImageInput", "SequenceIndicesEmbedding", "SingleIndexEmbedding",
           "StackedInput", "TableInput", "ValueInput", "save_tower_weights"]
