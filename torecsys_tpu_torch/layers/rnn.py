"""Recurrent cells and their scans: the port's counterpart of the parts of
``flax.linen.recurrent`` that the JAX package uses (its sequence inputs
and DSIN's interest interaction).

* :class:`OptimizedLSTMCell`, :class:`GRUCell` and :class:`SimpleCell`:
  flax's cells, with flax's parameter names (``ii``/``if``/``ig``/``io``
  input kernels without bias and ``hi``/``hf``/``hg``/``ho`` recurrent
  kernels with bias; ``ir``/``iz``/``in`` with bias and ``hr``/``hz``
  without, ``hn`` with; ``i`` with bias and ``h`` without), each a
  ``weight`` (flax's ``kernel`` transposed) and a ``bias``.  They draw
  flax's defaults: lecun-normal input kernels, orthogonal recurrent
  kernels, zero biases.  They have no compute dtype: as flax's cells
  promote the input to their float32 kernels, a bf16 input is computed in
  float32, and the carry and outputs are float32.
* :class:`RNN` — flax's ``nn.RNN`` over ``(B, L, F)``, batch-major: a zero
  carry, the cell applied at each of the L steps (past a sequence's length
  too: nothing is masked), with ``seq_lengths``, ``reverse`` and
  ``keep_order`` as in flax.
* :func:`flip_sequences` — flax's: each sequence reversed within its length,
  the padding after it reversed in place at the end.
* :class:`Bidirectional` — a forward and a backward :class:`RNN` (``reverse``
  and ``keep_order``), their outputs concatenated.

flax names a cell in the scope of the module that creates it, in creation
order (``OptimizedLSTMCell_0``, ``GRUCell_3``), not under its ``RNN``, so
:class:`RNN` and :class:`Bidirectional` are plain callables that own no
parameters: the module that builds the cells registers them under those
names, and ``convert`` maps them by its generic rule.

The input projections of all L steps are one product before the scan (the
JAX package projects each step inside it); each step then takes one
recurrent product and the gates' elementwise work, in flax's order of
operations.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torecsys_tpu_torch.layers.ctr.dense import _TRUNC_STD
from torecsys_tpu_torch.utils import DeviceLike, default_generator, resolve_device


class _DenseParams(nn.Module):
    """One of a cell's projections: ``weight`` ``(out, in)`` (flax's
    ``kernel`` transposed) and, with ``use_bias``, ``bias`` ``(out,)``.
    ``recurrent`` draws the weight orthogonal (flax's ``orthogonal()``),
    else lecun-normal (flax's ``lecun_normal()``)."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool, recurrent: bool,
                 device: torch.device):
        super().__init__()
        self.recurrent = recurrent
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = (nn.Parameter(torch.empty(out_features, device=device)) if use_bias
                     else None)

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            if self.recurrent:
                # flax draws the (in, out) kernel orthogonal; its transpose is too
                q, r = torch.linalg.qr(torch.randn(self.weight.shape, generator=generator,
                                                   device=self.weight.device))
                self.weight.copy_(q * torch.sign(torch.diagonal(r))[None, :])
            else:
                std = math.sqrt(1.0 / self.weight.shape[1]) / _TRUNC_STD
                nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
            if self.bias is not None:
                self.bias.zero_()


class _Cell(nn.Module):
    """What the three cells share: their projections by flax name, built
    from ``_PROJECTIONS`` (name → (input side, use_bias)), and the input
    projection of a whole sequence at once."""

    _PROJECTIONS: Tuple[Tuple[str, bool, bool], ...] = ()
    _INPUT: Tuple[str, ...] = ()     # the input projections, in the order of their outputs

    def __init__(self, in_features: int, features: int, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.in_features = in_features
        self.features = features
        for name, from_input, use_bias in self._PROJECTIONS:
            # 'if' and 'in' are Python keywords: add_module takes them as names
            self.add_module(name, _DenseParams(in_features if from_input else features,
                                               features, use_bias, not from_input, dev))
        self.reset_parameters(default_generator(dev, generator=generator))

    def reset_parameters(self, generator=None) -> None:
        for name, _, _ in self._PROJECTIONS:
            getattr(self, name).reset_parameters(generator)

    def initialize_carry(self, batch: int, device) -> torch.Tensor:
        return torch.zeros(batch, self.features, device=device)

    def _stacked(self, names: Sequence[str]) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The projections ``names`` as one ``(len * H, in)`` weight and
        their biases (None where they have none)."""
        mods = [getattr(self, n) for n in names]
        weight = torch.cat([m.weight for m in mods])
        if mods[0].bias is None:
            return weight, None
        return weight, torch.cat([m.bias for m in mods])

    def forward(self, carry, inputs: torch.Tensor):
        """One step, flax's ``cell(carry, x) → (carry, y)`` on ``(B, in)``."""
        return self.step_fn()(carry, self.project_inputs(inputs))

    def project_inputs(self, inputs: torch.Tensor) -> torch.Tensor:
        """``(..., in) → (..., k * H)``: every step's input projections,
        each rounded, then its bias added, as flax's ``Dense`` takes them.
        A bf16 input is promoted to float32 first, as flax promotes it."""
        weight, bias = self._stacked(self._INPUT)
        y = F.linear(inputs.to(torch.float32), weight)
        return y if bias is None else y + bias


class OptimizedLSTMCell(_Cell):
    """flax ``nn.OptimizedLSTMCell(features)``: ``i, f, o = σ(W_h· h + b_h
    + W_i· x)``, ``g = tanh(...)``, ``c' = f·c + i·g``, ``h' =
    o·tanh(c')``; the carry is ``(c, h)``."""

    _PROJECTIONS = tuple((f"{side}{gate}", side == "i", side == "h")
                         for gate in "ifgo" for side in "ih")
    _INPUT = ("ii", "if", "ig", "io")

    def initialize_carry(self, batch: int, device):
        zeros = super().initialize_carry(batch, device)
        return zeros, zeros.clone()

    def step_fn(self):
        """``(carry, projected x_t) → (carry, h_t)`` with the recurrent
        weights stacked once."""
        weight, bias = self._stacked(("hi", "hf", "hg", "ho"))

        def step(carry, xi):
            c, h = carry
            dense_h = (F.linear(h, weight) + bias).chunk(4, dim=-1)
            dense_i = xi.chunk(4, dim=-1)
            i = torch.sigmoid(dense_h[0] + dense_i[0])
            f = torch.sigmoid(dense_h[1] + dense_i[1])
            g = torch.tanh(dense_h[2] + dense_i[2])
            o = torch.sigmoid(dense_h[3] + dense_i[3])
            new_c = f * c + i * g
            new_h = o * torch.tanh(new_c)
            return (new_c, new_h), new_h

        return step


class GRUCell(_Cell):
    """flax ``nn.GRUCell(features)``: ``r = σ(W_ir x + b_ir + W_hr h)``,
    ``z = σ(W_iz x + b_iz + W_hz h)``, ``n = tanh(W_in x + b_in + r·(W_hn h
    + b_hn))``, ``h' = (1 - z)·n + z·h``."""

    _PROJECTIONS = (("ir", True, True), ("hr", False, False), ("iz", True, True),
                    ("hz", False, False), ("in", True, True), ("hn", False, True))
    _INPUT = ("ir", "iz", "in")

    def step_fn(self):
        weight = torch.cat([self.hr.weight, self.hz.weight, self.hn.weight])
        hn_bias = self.hn.bias

        def step(h, xi):
            x_r, x_z, x_n = xi.chunk(3, dim=-1)
            h_r, h_z, h_n = F.linear(h, weight).chunk(3, dim=-1)
            r = torch.sigmoid(x_r + h_r)
            z = torch.sigmoid(x_z + h_z)
            n = torch.tanh(x_n + r * (h_n + hn_bias))
            new_h = (1.0 - z) * n + z * h
            return new_h, new_h

        return step


class SimpleCell(_Cell):
    """flax ``nn.SimpleCell(features)``: ``h' = tanh(W_i x + b_i + W_h h)``."""

    _PROJECTIONS = (("i", True, True), ("h", False, False))
    _INPUT = ("i",)

    def step_fn(self):
        weight = self.h.weight

        def step(h, xi):
            new_h = torch.tanh(xi + F.linear(h, weight))
            return new_h, new_h

        return step


def flip_sequences(inputs: torch.Tensor, seq_lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """flax's ``flip_sequences`` on batch-major ``(B, L, ...)``: without
    lengths the time axis reversed; with them, step ``t`` of row ``b`` takes
    step ``(L - 1 - t + len_b) mod L``, so each sequence is reversed within
    its length and the padding after it is reversed at the end."""
    if seq_lengths is None:
        return torch.flip(inputs, dims=(1,))
    max_steps = inputs.shape[1]
    idx = torch.arange(max_steps - 1, -1, -1, device=inputs.device)
    idx = (idx[None, :] + seq_lengths.to(torch.int64)[:, None]) % max_steps  # (B, L)
    idx = idx.reshape(*idx.shape, *(1,) * (inputs.dim() - 2)).expand_as(inputs)
    return torch.gather(inputs, 1, idx)


class RNN:
    """flax ``nn.RNN(cell)`` over batch-major ``(B, L, F) → (B, L, H)``.

    The carry starts at zero; the cell runs over all L steps (past a
    sequence's length too; nothing is masked).  ``reverse`` flips the
    input first (:func:`flip_sequences`, by ``seq_lengths`` when given) and
    leaves the output in that order, unless ``keep_order`` flips it back.
    ``seq_lengths`` does nothing else here: the JAX package never asks
    for the final carry.  The cell is the caller's registered submodule.
    """

    def __init__(self, cell: _Cell):
        self.cell = cell

    def __call__(self, inputs: torch.Tensor, seq_lengths: Optional[torch.Tensor] = None,
                 reverse: bool = False, keep_order: bool = False) -> torch.Tensor:
        if reverse:
            inputs = flip_sequences(inputs, seq_lengths)
        projected = self.cell.project_inputs(inputs)  # (B, L, k * H)
        step = self.cell.step_fn()
        carry = self.cell.initialize_carry(inputs.shape[0], inputs.device)
        outputs = []
        for t in range(inputs.shape[1]):
            carry, y = step(carry, projected[:, t])
            outputs.append(y)
        out = torch.stack(outputs, dim=1)
        if reverse and keep_order:
            out = flip_sequences(out, seq_lengths)
        return out


class Bidirectional:
    """flax ``nn.Bidirectional(forward_rnn, backward_rnn)``: the forward
    RNN, and the backward one with ``reverse=True, keep_order=True``, both
    with ``seq_lengths``; their outputs concatenated on the last axis."""

    def __init__(self, forward_rnn: RNN, backward_rnn: RNN):
        self.forward_rnn = forward_rnn
        self.backward_rnn = backward_rnn

    def __call__(self, inputs: torch.Tensor,
                 seq_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        fwd = self.forward_rnn(inputs, seq_lengths=seq_lengths)
        bwd = self.backward_rnn(inputs, seq_lengths=seq_lengths, reverse=True, keep_order=True)
        return torch.cat([fwd, bwd], dim=-1)


CELLS: Dict[str, type] = {"lstm": OptimizedLSTMCell, "gru": GRUCell, "rnn": SimpleCell}


__all__ = ["Bidirectional", "CELLS", "GRUCell", "OptimizedLSTMCell", "RNN", "SimpleCell",
           "flip_sequences"]
