"""Compressed Interaction Network, xDeepFM's CIN (counterpart of
``torecsys_tpu/layers/ctr/cin.py``), with the flax BatchNorm it uses."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from torecsys_tpu_torch.layers.ctr.dense import Dense, xavier_uniform_
from torecsys_tpu_torch.ops.interactions import cin_interaction
from torecsys_tpu_torch.utils import DeviceLike, default_generator, resolve_device


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(axis=axis, momentum=0.99, epsilon=1e-5)``: a
    feature's statistics reduce over every other axis.  ``axis=-2`` (the
    default) is the CIN's, on a ``(B, C, E)`` map (a channel ``c``'s
    statistics over ``(B, E)``); ``axis=-1`` is PRM's flax default, on a
    ``(B, L, D)`` sequence (a feature's over ``(B, L)``).

    This is flax's arithmetic, not ``nn.BatchNorm1d``'s: in training the
    statistics are computed in float32 the "fast" way, ``mean = E[x]`` and
    ``var = max(E[x²] − E[x]², 0)``, biased; the running statistics move as
    ``ra = momentum·ra + (1 − momentum)·batch``, where torch's running
    variance is unbiased and its momentum is the other weight.  Under a
    mesh whose data axis is split the batch's statistics are the global
    batch's (``parallel.lookup.data_mean``), as the JAX package's SPMD step
    takes them.  In
    ``eval()`` the running statistics normalize.  The output is
    ``(x − mean)·(rsqrt(var + eps)·scale) + bias``.

    Parameters ``scale`` (ones) and ``bias`` (zeros); the running
    statistics are float32 buffers ``mean`` (zeros) and ``var`` (ones), the
    JAX package's ``batch_stats``, updated in place so that a CUDA graph
    captured over them stays valid.
    """

    def __init__(self, num_features: int, momentum: float = 0.99, eps: float = 1e-5,
                 axis: int = -2, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        if axis >= 0:
            raise ValueError(f"axis counts from the end (-1, -2, ...), got {axis}")
        self.axis = axis
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(num_features, device=dev))
        self.bias = nn.Parameter(torch.zeros(num_features, device=dev))
        self.register_buffer("mean", torch.zeros(num_features, dtype=torch.float32, device=dev))
        self.register_buffer("var", torch.ones(num_features, dtype=torch.float32, device=dev))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axis = x.dim() + self.axis
        if self.training:
            from torecsys_tpu_torch.parallel.lookup import data_mean

            xf = x.float()
            dims = tuple(d for d in range(x.dim()) if d != axis)
            # E[x] and E[x²] of the global batch under a split data axis
            moments = data_mean(torch.stack([xf.mean(dim=dims), torch.square(xf).mean(dim=dims)]))
            mean = moments[0]
            var = torch.clamp_min(moments[1] - torch.square(mean), 0.0)
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        # each feature's vector broadcast along the axes after ``axis``
        tail = (1,) * (-self.axis - 1)
        return ((x - mean.reshape(-1, *tail)) * mul.reshape(-1, *tail)
                + self.bias.reshape(-1, *tail))


class CompressInteractionNetworkLayer(nn.Module):
    """CIN, ``(B, N, E) → (B, output_size)``: per layer ``k`` the compressed
    outer product of the previous map with the base
    (:func:`~torecsys_tpu_torch.ops.interactions.cin_interaction`, weights
    ``conv_{k}`` ``(H_k, H_{k-1}, N)``), plus ``bias_{k}`` ``(H_k, 1)``,
    :class:`BatchNorm` ``bn_{k}`` and the activation; the direct variant pools
    and feeds forward the whole map, the split-half one pools the first half
    and feeds the second forward (the last layer pools all of it).  The
    pooled maps are summed over E and go through the ``head``
    :class:`~torecsys_tpu_torch.layers.ctr.dense.Dense`.

    The interactions, the bias and the batch norm compute in float32; only
    the head follows ``compute_dtype``, as in the JAX package.
    """

    def __init__(self, embed_size: int, num_fields: int, output_size: int = 1,
                 layer_sizes: Sequence[int] = (128, 128), is_direct: bool = False,
                 use_bias: bool = True, use_batchnorm: bool = True,
                 activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.layer_sizes = tuple(int(h) for h in layer_sizes)
        self.is_direct = is_direct
        self.use_bias = use_bias
        self.use_batchnorm = use_batchnorm
        self.activation = activation
        h_prev, pooled = num_fields, 0
        for k, h in enumerate(self.layer_sizes):
            self.register_parameter(f"conv_{k}", nn.Parameter(
                torch.empty(h, h_prev, num_fields, device=dev)))
            if use_bias:
                self.register_parameter(f"bias_{k}",
                                        nn.Parameter(torch.empty(h, 1, device=dev)))
            if use_batchnorm:
                self.add_module(f"bn_{k}", BatchNorm(h, device=dev))
            if is_direct or k == len(self.layer_sizes) - 1:
                pooled, h_prev = pooled + h, h
            else:
                pooled, h_prev = pooled + h // 2, h - h // 2
        self.head = Dense(pooled, output_size, device=dev)
        self.reset_parameters(default_generator(dev, generator=generator))

    def reset_parameters(self, generator=None) -> None:
        for k in range(len(self.layer_sizes)):
            xavier_uniform_(getattr(self, f"conv_{k}"), generator)
            if self.use_bias:
                with torch.no_grad():
                    getattr(self, f"bias_{k}").zero_()
            if self.use_batchnorm:
                getattr(self, f"bn_{k}").reset_parameters(generator)
        self.head.reset_parameters(generator)

    def forward(self, emb_inputs: torch.Tensor) -> torch.Tensor:
        x0 = xk = emb_inputs
        pooled = []
        last = len(self.layer_sizes) - 1
        for k, h in enumerate(self.layer_sizes):
            z = cin_interaction(x0, xk, getattr(self, f"conv_{k}"))  # (B, h, E)
            if self.use_bias:
                z = z + getattr(self, f"bias_{k}")
            if self.use_batchnorm:
                z = getattr(self, f"bn_{k}")(z)
            z = self.activation(z)
            if self.is_direct or k == last:
                pooled.append(z)
                xk = z
            else:
                pooled.append(z[:, :h // 2])
                xk = z[:, h // 2:]
        out = torch.sum(torch.cat(pooled, dim=1), dim=2)  # (B, ΣH)
        return self.head(out)


__all__ = ["BatchNorm", "CompressInteractionNetworkLayer"]
