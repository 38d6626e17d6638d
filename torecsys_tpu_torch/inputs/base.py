"""Input-module base class and the field-format protocol.

Counterpart of ``torecsys_tpu/inputs/base.py``.  A batch is a
``Dict[str, Tensor]`` keyed by raw field name; each input module consumes the
fields named in its ``fields`` attribute and emits a canonical tensor
(``(B, N, E)`` embeddings, ``(B, N, 1)`` values).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

Batch = Dict[str, torch.Tensor]


class BaseInput(nn.Module):
    """Base class for all input (embedder) modules.

    Subclasses implement ``forward(batch) -> Tensor`` and expose ``fields``
    (the raw batch keys they consume) and ``embed_size``.
    """

    def reset_parameters(self, generator=None) -> None:
        """Re-draw this module's own parameters (none by default)."""

    @staticmethod
    def _stack_fields(batch: Batch, fields: Tuple[str, ...]) -> torch.Tensor:
        """Stack raw ``(B,)`` or ``(B, k)`` integer fields into ``(B, N)``."""
        cols = []
        for name in fields:
            x = batch[name]
            if x.dim() == 1:
                x = x[:, None]
            elif x.dim() > 2:
                raise ValueError(f"field {name!r} must be rank<=2, got {tuple(x.shape)}")
            cols.append(x)
        return torch.cat(cols, dim=1)
