"""Sequential glue: ``model(**inputs(batch))`` (counterpart of
``torecsys_tpu/models/sequential.py``)."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from torecsys_tpu_torch.inputs import Inputs


class Sequential(nn.Module):
    """``Sequential(inputs, model)(batch) == model(**inputs(batch))``."""

    def __init__(self, inputs: Inputs, model: nn.Module):
        super().__init__()
        self.inputs = inputs
        self.model = model

    def forward(self, batch: Dict[str, torch.Tensor]):
        out = self.model(**self.inputs(batch))
        # Towers may compute in bf16 (layers.precision); losses and metrics
        # always take float32 scores.
        return out.float() if out.dtype == torch.bfloat16 else out

    def reset_parameters(self, generator=None) -> None:
        """Re-draw every parameter from ``generator``: inputs, then model."""
        self.inputs.reset_parameters(generator)
        self.model.reset_parameters(generator)
