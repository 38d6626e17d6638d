"""Mixture-of-experts layer (counterpart of ``torecsys_tpu/layers/ctr/moe.py``)."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from torecsys_tpu_torch.layers.ctr.dense import Dense
from torecsys_tpu_torch.layers.precision import softmax
from torecsys_tpu_torch.utils import DeviceLike, default_generator, resolve_device


class MixtureOfExpertsLayer(nn.Module):
    """Gated mixture of experts, ``(B, N, E) → (B, num_gates,
    num_experts·O)``: K experts, each mapping the ``(B, N, E)`` input to
    ``(B, O)``, and a softmax gate (``gate``, a :class:`Dense` over the
    flattened ``(B, N·E)`` input to ``num_gates × K``); row ``g`` of the
    output is the concatenation of the K expert outputs, each weighted by
    gate ``g``'s share for it (a concatenation, not a sum, as in the JAX
    package).

    Args:
        num_fields, embed_size: the input's N and E.
        expert_factory: ``in_features → expert module``, called once per
            expert with ``N·E``; the experts must agree on O.
        num_experts: K.
        num_gates: the gates (MMoE's tasks).

    Each expert is named as flax names a module built inside a compact
    method, its class name and its index, ``_FlatMLPExpert_0`` ..., so that
    its parameters sit at the JAX package's paths.  The gate follows
    ``compute_dtype``, and its softmax runs in its output's dtype.
    """

    def __init__(self, num_fields: int, embed_size: int,
                 expert_factory: Callable[[int], nn.Module], num_experts: int,
                 num_gates: int = 1, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        in_features = num_fields * embed_size
        self.num_experts = num_experts
        self.num_gates = num_gates
        self.experts = []
        for _ in range(num_experts):
            expert = expert_factory(in_features)
            name = f"{type(expert).__name__}_{len(self.experts)}"
            self.add_module(name, expert)
            self.experts.append(name)
        self.gate = Dense(in_features, num_experts * num_gates, device=dev)
        self.reset_parameters(default_generator(dev, generator=generator))

    def reset_parameters(self, generator=None) -> None:
        for name in self.experts:
            getattr(self, name).reset_parameters(generator)
        self.gate.reset_parameters(generator)

    def forward(self, emb_inputs: torch.Tensor) -> torch.Tensor:
        b = emb_inputs.shape[0]
        experts = torch.stack([getattr(self, name)(emb_inputs).reshape(b, -1)
                               for name in self.experts], dim=1)  # (B, K, O)
        gates = self.gate(emb_inputs.reshape(b, -1))
        gates = softmax(gates.reshape(b, self.num_gates, self.num_experts), dim=-1)
        # (B, G, K, 1) x (B, 1, K, O): the gate-weighted expert outputs
        weighted = gates[..., None] * experts[:, None, :, :]
        return weighted.reshape(b, self.num_gates, -1)


__all__ = ["MixtureOfExpertsLayer"]
