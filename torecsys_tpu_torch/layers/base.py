"""Layer base class (counterpart of ``torecsys_tpu/layers/base.py``): a
module whose docstring states its ``(B, N, E) → ...`` shape contract, with
the optional ``inputs_size`` / ``outputs_size`` properties kept for the
API's sake."""

from __future__ import annotations

from typing import Dict, Optional

from torch import nn


class BaseLayer(nn.Module):
    """Base class of the interaction layers (shape contracts in docstrings)."""

    @property
    def inputs_size(self) -> Optional[Dict[str, str]]:
        return None

    @property
    def outputs_size(self) -> Optional[Dict[str, str]]:
        return None


__all__ = ["BaseLayer"]
