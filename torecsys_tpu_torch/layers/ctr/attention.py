"""Field attention (counterpart of ``ComposeExcitationNetworkLayer`` in
``torecsys_tpu/layers/ctr/attention.py``; the module's positional and
bias-encoding layers are not ported yet)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from torecsys_tpu_torch.layers.ctr.dense import Dense
from torecsys_tpu_torch.utils import DeviceLike, default_generator, resolve_device


class ComposeExcitationNetworkLayer(nn.Module):
    """SENET over fields: squeeze (the mean over E of each field), the
    excitation ``reduce`` (M → max(1, M // reduction)), ReLU, ``expand``
    (→ M), ReLU, and the fields re-weighted: ``(B, M, E) → (B, M, E)``, with
    M = N, or N² with ``squared=True`` (a field-aware embedding's).

    Both products are :class:`Dense` and follow the pipeline's
    ``compute_dtype``, as the JAX package's precision ``Dense`` does; a bf16
    attention re-weights the float32 fields in float32.
    """

    def __init__(self, num_fields: int, reduction: int = 1, squared: bool = False,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        m = num_fields ** 2 if squared else num_fields
        hidden = max(1, m // reduction)
        self.reduce = Dense(m, hidden, device=dev)
        self.expand = Dense(hidden, m, device=dev)
        self.reset_parameters(default_generator(dev, generator=generator))

    def reset_parameters(self, generator=None) -> None:
        self.reduce.reset_parameters(generator)
        self.expand.reset_parameters(generator)

    def forward(self, field_emb_inputs: torch.Tensor) -> torch.Tensor:
        squeezed = torch.mean(field_emb_inputs, dim=2)  # (B, M)
        attn = torch.relu(self.expand(torch.relu(self.reduce(squeezed))))
        return field_emb_inputs * attn[..., None]


__all__ = ["ComposeExcitationNetworkLayer"]
