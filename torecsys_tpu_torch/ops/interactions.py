"""Interaction primitives (counterpart of ``torecsys_tpu/ops/interactions.py``).

Each is a plain function of tensors, as in the JAX package: one pair-index
gather and one fused product instead of Python pair loops.  The JAX package
computes all of them outside any Pallas kernel (XLA's einsums and
gathers), so here they are PyTorch operations; their products are
``torch.matmul`` (cuBLAS on the card).  Two run hand-written kernels on the
card, through one wrapper forward and one backward each: the port's own DCN-v2
combine, :func:`low_rank_cross`, which the JAX package lacks
(``ops.kernels.cross``), and the CIN's compression, :func:`cin_interaction`,
whose outer product the kernels form as they load it (``ops.kernels.cin``).
The pairs ``i < j`` come in the JAX package's row-major order from
``torch.triu_indices`` on the inputs' device: no copy from the host, so a CUDA
graph can capture them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torecsys_tpu_torch.ops.kernels import cin as _cin
from torecsys_tpu_torch.ops.kernels import cross as _cross


def _pairs(n: int, device: torch.device):
    """``(rows, cols)`` of the ``C(n, 2)`` pairs ``i < j``, row-major."""
    return torch.triu_indices(n, n, 1, device=device).unbind(0)


def fm_pairwise_interaction(emb_inputs: torch.Tensor) -> torch.Tensor:
    """Factorization-machine second-order interaction over the field axis:
    ``0.5 * ((sum_n v_n)^2 - sum_n v_n^2)``, ``(B, N, E) → (B, E)``."""
    sum_sq = torch.square(torch.sum(emb_inputs, dim=1))
    sq_sum = torch.sum(torch.square(emb_inputs), dim=1)
    return 0.5 * (sum_sq - sq_sum)


def ffm_pairwise_interaction(field_emb_inputs: torch.Tensor, num_fields: int) -> torch.Tensor:
    """Field-aware FM interaction: ``(B, N*N, E) → (B, C(N,2), E)``.

    Entry ``i*N + j`` of the input is field ``j``'s embedding in field-aware
    table ``i``; the output holds ``x[:, i, j] * x[:, j, i]`` for each pair
    ``i < j`` in row-major order.
    """
    b, nn_, e = field_emb_inputs.shape
    n = num_fields
    if nn_ != n * n:
        raise ValueError(f"expected N*N={n * n} second dim, got {nn_}")
    x = field_emb_inputs.reshape(b, n, n, e)
    rows, cols = _pairs(n, x.device)
    return x[:, rows, cols, :] * x[:, cols, rows, :]


def afm_pairwise_products(emb_inputs: torch.Tensor) -> torch.Tensor:
    """All (i<j) Hadamard products of field embeddings: ``(B, N, E) →
    (B, C(N,2), E)``."""
    rows, cols = _pairs(emb_inputs.shape[1], emb_inputs.device)
    return emb_inputs[:, rows, :] * emb_inputs[:, cols, :]


def inner_product_pairs(emb_inputs: torch.Tensor) -> torch.Tensor:
    """Pairwise inner products ``<v_i, v_j>`` for i<j: ``(B, N, E) →
    (B, C(N,2))``, the pairs of one batched Gram matrix."""
    rows, cols = _pairs(emb_inputs.shape[1], emb_inputs.device)
    gram = torch.matmul(emb_inputs, emb_inputs.transpose(1, 2))
    return gram[:, rows, cols]


def outer_product_pairs(emb_inputs: torch.Tensor, kernel: torch.Tensor,
                        kernel_type: str = "mat") -> torch.Tensor:
    """Kernel-compressed pairwise outer products (PNN 'outer'): ``(B, N, E)
    → (B, C(N,2))``.

    ``kernel`` is in the JAX package's layout: ``(E, C(N,2), E)`` for
    ``mat``, ``(C(N,2), E)`` for ``vec``, ``(C(N,2), 1)`` for ``num``.
    """
    rows, cols = _pairs(emb_inputs.shape[1], emb_inputs.device)
    p = emb_inputs[:, rows, :]  # (B, P, E)
    q = emb_inputs[:, cols, :]
    if kernel_type == "mat":
        # sum_e sum_f p_bpe K_epf q_bpf: per pair, (B, E) @ (E, E), then
        # the row-wise dot with q
        pk = torch.matmul(p.transpose(0, 1), kernel.permute(1, 0, 2))  # (P, B, E)
        return torch.sum(pk.transpose(0, 1) * q, dim=-1)
    if kernel_type == "vec":
        return torch.sum(p * q * kernel[None], dim=-1)
    if kernel_type == "num":
        return torch.sum(p * q, dim=-1) * kernel.reshape(1, -1)
    raise ValueError(f"unknown kernel_type {kernel_type!r}")


def cross_layer(x0: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """One DCN cross layer ``x' = x0 * (x . w) + b + x`` on ``(B, D)``, the
    true DCN-v1 recurrence as in the JAX package."""
    xw = torch.matmul(x, weight)  # (B,)
    return x0 * xw[:, None] + bias[None, :] + x


class _LowRankCross(torch.autograd.Function):
    """One low-rank cross layer's combine, forward and backward each one
    pass (``ops.kernels.cross``; the plain versions on the CPU).  Keeps
    ``x0``, ``y`` and ``b`` for the backward, which recomputes ``p`` from
    them: no float32 ``p`` is kept.  Its third output is ``x0`` for the next
    layer: that layer's gradient of ``x0`` comes back through it, and the
    backward adds it into its own, in the same pass; so does the gradient of
    ``x`` where ``x`` is ``x0`` itself (the first layer)."""

    @staticmethod
    def forward(ctx, x0, x, y, bias, copy):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x0, y, bias)
        ctx.x_is_x0 = x is x0
        out, out_copy = _cross.low_rank_cross_forward(x0, x, y, bias, copy)
        return out, out_copy, x0.view_as(x0)

    @staticmethod
    def backward(ctx, grad, grad_copy, grad_x0):
        x0, y, bias = ctx.saved_tensors
        # autograd may hand in a strided or expanded gradient (``sum()``'s):
        # the kernel reads rows of D packed elements
        grad, grad_copy, grad_x0 = (None if g is None else g.contiguous()
                                    for g in (grad, grad_copy, grad_x0))
        dx0, dx, dy, dbias = _cross.low_rank_cross_backward(grad, grad_copy, grad_x0, x0, y,
                                                            bias, ctx.x_is_x0)
        return dx0, dx, dy, dbias, None


def low_rank_cross(x0: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   bias: Optional[torch.Tensor] = None, last: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One DCN-v2 low-rank cross layer's combine on ``(B, D)``: ``x' = x0 *
    (y + b) + x`` in ``x0``'s dtype, with ``y + b`` in ``y``'s dtype; ``y =
    U (V x)`` and ``b`` are the layer's
    (``layers.ctr.cross.LowRankCrossNetworkLayer``; ``bias`` None where
    ``y`` already holds it); ``x`` is ``x0`` itself in the first layer.

    Returns ``(x', v_input, x0)``: ``v_input`` is what the next layer's V
    product reads, ``x'`` in ``y``'s dtype, written by the same pass, where
    the dtypes differ and the layer is not the ``last``, else ``x'``; ``x0``
    is for the next layer's combine (the same values; through it that
    layer's gradient of ``x0`` reaches this layer's backward, which adds it
    in the same pass).  Differentiable in ``x0``, ``x``, ``y`` and
    ``bias``; one kernel forward and one backward on the card
    (``ops.kernels.cross``)."""
    out, out_copy, x0 = _LowRankCross.apply(x0, x, y, bias, not last and y.dtype != x0.dtype)
    return out, out if out_copy is None else out_copy, x0


class _Cin(torch.autograd.Function):
    """One CIN compression, forward and backward (``ops.kernels.cin``: the
    forward kernel, and the input and weight kernels backward, on the card;
    the plain composition and autograd's backward through it on the CPU).
    Keeps ``x0``, ``xk`` and the weight for the backward: no outer product
    is kept, nor ever written on the card."""

    @staticmethod
    def forward(ctx, x0, xk, weight):
        ctx.save_for_backward(x0, xk, weight)
        return _cin.cin_forward(x0, xk, weight)

    @staticmethod
    def backward(ctx, grad):
        x0, xk, weight = ctx.saved_tensors
        # autograd may hand in a strided or expanded gradient: the kernels read
        # a packed (B, O, E)
        return _cin.cin_backward(grad.contiguous(), x0, xk, weight)


def cin_interaction(x0: torch.Tensor, xk: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """One CIN (xDeepFM) step: ``(B, N, E)`` base, ``(B, H, E)`` previous map
    and ``(O, H, N)`` weights → ``(B, O, E)``, ``out[b, o, e] = sum_{h, n}
    W[o, h, n] xk[b, h, e] x0[b, n, e]``.

    On the CPU the outer product is formed explicitly and compressed by one
    product (``ops.kernels.cin.cin_forward_plain``: the JAX package's
    three-operand einsum in a contraction order that is fixed), a ``(B, O,
    E)`` view of the ``(O, B, E)`` product; on the card hand-written kernels
    form it as they load their operands and write a packed ``(B, O, E)``
    (``ops.kernels.cin``).  Differentiable in all three; ``xk`` may be
    strided along B and H.
    """
    return _Cin.apply(x0, xk, weight)


__all__ = ["afm_pairwise_products", "cin_interaction", "cross_layer",
           "ffm_pairwise_interaction", "fm_pairwise_interaction", "inner_product_pairs",
           "low_rank_cross", "outer_product_pairs"]
