"""Sequential glue: ``model(**inputs(batch))`` (counterpart of
``torecsys_tpu/models/sequential.py``)."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from torecsys_tpu_torch.inputs import Inputs


def _to_float32(out):
    """``out`` with each bf16 tensor leaf cast to float32 (the JAX package's
    ``tree_map`` over the output); every other leaf as it is."""
    if isinstance(out, torch.Tensor):
        return out.float() if out.dtype == torch.bfloat16 else out
    if isinstance(out, (tuple, list)):
        return type(out)(_to_float32(x) for x in out)
    if isinstance(out, dict):
        return {k: _to_float32(v) for k, v in out.items()}
    return out


class Sequential(nn.Module):
    """``Sequential(inputs, model)(batch) == model(**inputs(batch))``."""

    def __init__(self, inputs: Inputs, model: nn.Module):
        super().__init__()
        self.inputs = inputs
        self.model = model

    def forward(self, batch: Dict[str, torch.Tensor]):
        out = self.model(**self.inputs(batch))
        # Towers may compute in bf16 (layers.precision); losses and metrics
        # always take float32 scores: each bf16 tensor of the output (one
        # tensor, or a tuple, list or dict of them: ESMM's heads) is cast.
        return _to_float32(out)

    def reset_parameters(self, generator=None) -> None:
        """Re-draw every parameter from ``generator``: inputs, then model."""
        self.inputs.reset_parameters(generator)
        self.model.reset_parameters(generator)
