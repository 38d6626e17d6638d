"""Field attention, positional layers and multi-head attention (counterpart
of ``torecsys_tpu/layers/ctr/attention.py``, with the twin of flax's
``nn.MultiHeadDotProductAttention`` as the JAX package calls it).

* :class:`ComposeExcitationNetworkLayer` — SENET over fields (FiBiNET,
  FAT-DeepFFM);
* :class:`BiasEncodingLayer` — DSIN's session, position and unit biases;
* :class:`PositionEmbeddingLayer` — PRM's ``(1, L, 1)`` positional bias;
* :class:`PositionBiasAwareLearningFrameworkLayer` — PAL's position-bias
  table, read by position id;
* :class:`MultiHeadDotProductAttention` — flax's multi-head attention on
  ``(x, x)`` (PRM's encoder blocks, DSIN's interest extractor).

The flax parameters keep their names and shapes: ``session_bias``
``(S,)``, ``position_bias`` ``(L,)``, ``unit_bias`` ``(E,)``,
``position_embedding``; the attention's ``query``, ``key``, ``value`` and
``out`` projections are :class:`DenseGeneral`, whose ``weight`` is flax's
``kernel`` with its axes reversed (``convert`` carries it by its generic
rule).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from torecsys_tpu_torch.layers.ctr.dense import _TRUNC_STD, Dense
from torecsys_tpu_torch.layers.precision import softmax
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


class BiasEncodingLayer(nn.Module):
    """DSIN's bias encoding, ``((B, L, E), (B,)) → (B, L, E)``: each
    example's session bias (``session_bias`` taken at its session index),
    the ``position_bias`` of each of the L positions and the ``unit_bias``
    of each of the E units added to the session embeddings.  The three
    parameters are drawn from N(0, 0.01²), as flax's ``normal(0.01)``."""

    def __init__(self, max_num_session: int, max_length: int, embed_size: int,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.session_bias = nn.Parameter(torch.empty(max_num_session, device=dev))
        self.position_bias = nn.Parameter(torch.empty(max_length, device=dev))
        self.unit_bias = nn.Parameter(torch.empty(embed_size, device=dev))
        self.reset_parameters(default_generator(dev, generator=generator))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            for p in (self.session_bias, self.position_bias, self.unit_bias):
                p.normal_(0.0, 0.01, generator=generator)

    def forward(self, session_embs: torch.Tensor, session_index: torch.Tensor) -> torch.Tensor:
        session = self.session_bias[session_index.to(torch.int64)]  # (B,)
        return (session_embs + session[:, None, None] + self.position_bias[None, :, None]
                + self.unit_bias[None, None, :])


class PositionEmbeddingLayer(nn.Module):
    """PRM's learnable positional bias over the list axis,
    ``(B, L, E) → (B, L, E)``, with a ``(1, L, 1)`` parameter
    ``position_embedding`` drawn from N(0, 0.01²)."""

    def __init__(self, max_num_position: int, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.position_embedding = nn.Parameter(torch.empty(1, max_num_position, 1, device=dev))
        self.reset_parameters(default_generator(dev, generator=generator))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.position_embedding.normal_(0.0, 0.01, generator=generator)

    def forward(self, session_embs: torch.Tensor) -> torch.Tensor:
        return session_embs + self.position_embedding


class PositionBiasAwareLearningFrameworkLayer(nn.Module):
    """PAL's position bias, ``((B, E), (B,)) → (B, E)``: the row of the
    ``(max_num_position, input_size)`` table ``position_embedding`` (N(0,
    0.01²)) at each example's position id, added to its features."""

    def __init__(self, input_size: int, max_num_position: int, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.position_embedding = nn.Parameter(
            torch.empty(max_num_position, input_size, device=dev))
        self.reset_parameters(default_generator(dev, generator=generator))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.position_embedding.normal_(0.0, 0.01, generator=generator)

    def forward(self, feature: torch.Tensor, position: torch.Tensor) -> torch.Tensor:
        return feature + self.position_embedding[position.to(torch.int64)]


class DenseGeneral(nn.Module):
    """flax ``nn.DenseGeneral`` over the trailing ``in_shape`` axes to
    ``out_shape`` features: ``(..., *in_shape) → (..., *out_shape)``.

    ``weight`` is flax's ``kernel`` ``(*in_shape, *out_shape)`` with its
    axes reversed, and ``bias`` flax's ``(*out_shape,)``; both are drawn as
    flax draws them (lecun-normal over the flattened fan-in, zeros).  The
    product is one matrix product over the flattened axes, rounded, then
    the bias is added, as flax does it.  ``dtype`` (None:
    float32) casts the input, weight and bias first, as flax's ``dtype=``
    does; the caller sets it.
    """

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int],
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.in_shape = tuple(int(d) for d in in_shape)
        self.out_shape = tuple(int(d) for d in out_shape)
        kernel = (*self.in_shape, *self.out_shape)
        self.weight = nn.Parameter(torch.empty(kernel[::-1], device=dev))
        self.bias = nn.Parameter(torch.empty(self.out_shape, device=dev))
        self.reset_parameters(default_generator(dev, generator=generator))

    def reset_parameters(self, generator=None) -> None:
        std = math.sqrt(1.0 / math.prod(self.in_shape)) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        n_in, n_out = math.prod(self.in_shape), math.prod(self.out_shape)
        lead = x.shape[:x.dim() - len(self.in_shape)]
        # the (out, in) matrix of flax's kernel reshaped to (in, out)
        kernel = self.weight.permute(*reversed(range(self.weight.dim())))
        weight, bias = kernel.reshape(n_in, n_out).t(), self.bias.reshape(n_out)
        x = x.reshape(*lead, n_in)
        if dtype is not None:
            x, weight, bias = x.to(dtype), weight.to(dtype), bias.to(dtype)
        # the product rounded to its dtype, then the bias added, as flax's
        # DenseGeneral adds it (one rounding each in bf16)
        return (F.linear(x, weight) + bias).reshape(*lead, *self.out_shape)


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python number (a host-side op)."""
    return torch.tensor(value, dtype=dtype).item()


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention(num_heads, qkv_features,
    dropout_rate)`` applied to ``(x, x)``: ``(B, L, in_features) → (B, L,
    out_features)`` (``out_features`` defaults to ``in_features``, as
    flax's).

    ``query``, ``key`` and ``value`` project to ``(B, L, H, D/H)``
    (:class:`DenseGeneral`, flax kernels ``(in, H, D/H)``, biases ``(H,
    D/H)``); the query is divided by ``sqrt(D/H)``, the scores
    ``q·k`` over the head depth go through a softmax over the keys (the
    arithmetic of ``jax.nn.softmax``, ``layers.precision.softmax``), in
    training dropped at ``dropout_rate`` with one mask over ``(L, L)``
    broadcast across the batch and the heads (flax's ``broadcast_dropout``;
    the draws are torch's), weight the values, and ``out`` maps the heads
    back (flax kernel ``(H, D/H, out)``).

    ``mask`` (optional, boolean, broadcast to ``(B, H, L, L)``): the
    scores where it is False become ``finfo(dtype).min`` before the
    softmax, as flax's; a query with every key masked gets a uniform
    softmax, as in flax.

    ``compute_dtype`` (the JAX package's ``mha_dtype()``, set by the
    pipeline, ``layers.precision``): under bf16 every product, the scores
    and their softmax run in bf16 and the output is bf16; the parameters
    stay float32.  ``follows_pipeline=False`` keeps it float32, a flax
    attention built without ``dtype=``.
    """

    def __init__(self, in_features: int, num_heads: int, qkv_features: Optional[int] = None,
                 out_features: Optional[int] = None, dropout_rate: float = 0.0,
                 follows_pipeline: bool = True, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.follows_pipeline = follows_pipeline
        dev = resolve_device(device)
        qkv = in_features if qkv_features is None else qkv_features
        if qkv % num_heads:
            raise ValueError(f"qkv_features ({qkv}) must be divisible by num_heads "
                             f"({num_heads})")
        out = in_features if out_features is None else out_features
        self.num_heads = num_heads
        self.head_dim = qkv // num_heads
        self.dropout_rate = dropout_rate
        heads = (num_heads, self.head_dim)
        self.query = DenseGeneral((in_features,), heads, device=dev)
        self.key = DenseGeneral((in_features,), heads, device=dev)
        self.value = DenseGeneral((in_features,), heads, device=dev)
        self.out = DenseGeneral(heads, (out,), device=dev)
        self.compute_dtype: Optional[torch.dtype] = None
        self.reset_parameters(default_generator(dev, generator=generator))

    def reset_parameters(self, generator=None) -> None:
        for proj in (self.query, self.key, self.value, self.out):
            proj.reset_parameters(generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dtype = self.compute_dtype
        q = self.query(x, dtype)  # (B, L, H, D/H)
        k = self.key(x, dtype)
        v = self.value(x, dtype)
        # flax divides by sqrt(D/H) cast to the compute dtype: the divisor is
        # that value as a Python number (no copy to the card in a captured step)
        q = q / _in_dtype(math.sqrt(self.head_dim), q.dtype)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
        weights = softmax(scores, dim=-1)
        if self.training and self.dropout_rate > 0.0:
            keep = 1.0 - self.dropout_rate
            mask = torch.rand(weights.shape[-2:], device=x.device) < keep
            weights = weights * (mask.to(weights.dtype) / _in_dtype(keep, weights.dtype))
        attended = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.out(attended, dtype)


__all__ = ["BiasEncodingLayer", "ComposeExcitationNetworkLayer", "DenseGeneral",
           "MultiHeadDotProductAttention", "PositionBiasAwareLearningFrameworkLayer",
           "PositionEmbeddingLayer"]
