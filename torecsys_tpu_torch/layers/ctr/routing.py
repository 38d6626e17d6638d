"""Dynamic routing: MIND's behaviour-to-interest capsules (counterpart of
``torecsys_tpu/layers/ctr/routing.py``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from torecsys_tpu_torch.layers.base import BaseLayer
from torecsys_tpu_torch.layers.ctr.dense import xavier_uniform_
from torecsys_tpu_torch.layers.precision import softmax
from torecsys_tpu_torch.utils import DeviceLike, default_generator, resolve_device
from torecsys_tpu_torch.utils.operations import squash


def resolve_num_capsules(num_fields: int, max_num_caps: int) -> int:
    """The number of interests, ``max(1, min(K_max, int(log2(N))))``, fixed
    when the layer is built."""
    return max(1, min(max_num_caps, int(math.log2(max(num_fields, 2)))))


class DynamicRoutingLayer(BaseLayer):
    """B2I capsule routing: behaviours ``(B, N, E)`` → interests ``(B, K,
    O)``, K = :func:`resolve_num_capsules` ``(num_fields, max_num_caps)``.

    The behaviours are projected by ``shared_projection`` ``(E, O)``
    (flax's xavier-uniform; kept in flax's layout).  The coupling logits
    start at ``routing_logits`` ``(1, K, N)`` (N(0, 1)) and run
    ``num_iter`` iterations, unrolled: a softmax over the capsules, the
    coupled sum of the projections, ``squash``; between iterations the
    logits add the agreement of the capsules with the projections, which
    are detached there (the JAX package's ``stop_gradient``).
    """

    def __init__(self, embed_size: int, routed_size: int, max_num_caps: int, num_fields: int,
                 num_iter: int = 3, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.num_iter = num_iter
        k = resolve_num_capsules(num_fields, max_num_caps)
        self.shared_projection = nn.Parameter(torch.empty(embed_size, routed_size, device=dev))
        self.routing_logits = nn.Parameter(torch.empty(1, k, num_fields, device=dev))
        self.reset_parameters(default_generator(dev, generator=generator))

    def reset_parameters(self, generator=None) -> None:
        xavier_uniform_(self.shared_projection, generator)
        with torch.no_grad():
            self.routing_logits.normal_(0.0, 1.0, generator=generator)

    def forward(self, emb_inputs: torch.Tensor) -> torch.Tensor:
        b = emb_inputs.shape[0]
        u = torch.einsum("bne,eo->bno", emb_inputs, self.shared_projection)
        logits = self.routing_logits.expand(b, -1, -1)
        v = None
        for it in range(self.num_iter):
            c = softmax(logits, dim=1)  # couple over the capsules
            v = squash(torch.einsum("bkn,bno->bko", c, u), dim=-1)  # (B, K, O)
            if it < self.num_iter - 1:
                logits = logits + torch.einsum("bko,bno->bkn", v, u.detach())
        return v


__all__ = ["DynamicRoutingLayer", "resolve_num_capsules"]
