"""Interaction primitives (counterpart of ``torecsys_tpu/ops/interactions.py``).

Each is a plain function of tensors, as in the JAX package: one pair-index
gather and one fused product instead of Python pair loops.  The JAX package
computes all of them outside any Pallas kernel (XLA's einsums and
gathers), so here they are PyTorch operations; their products are
``torch.matmul`` (cuBLAS on the card).  The pairs ``i < j`` come in the
JAX package's row-major order from ``torch.triu_indices`` on the inputs'
device: no copy from the host, so a CUDA graph can capture them.
"""

from __future__ import annotations

import torch


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


def low_rank_cross(x0: torch.Tensor, x: torch.Tensor, projected: torch.Tensor) -> torch.Tensor:
    """One DCN-v2 low-rank cross layer's combine on ``(B, D)``: ``x' = x0 *
    projected + x``, ``projected = U (V x) + b`` (its products are the
    layer's, ``layers.ctr.cross.LowRankCrossNetworkLayer``), in ``x0``'s
    dtype."""
    return x0 * projected.to(x0.dtype) + x


def cin_interaction(x0: torch.Tensor, xk: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """One CIN (xDeepFM) step: ``(B, N, E)`` base, ``(B, H, E)`` previous map
    and ``(O, H, N)`` weights → ``(B, O, E)``.

    The outer product ``z[h*N + n, b, e] = xk[b, h, e] * x0[b, n, e]`` is
    formed explicitly, and compressed by one product ``W.reshape(O, H*N) @
    z.reshape(H*N, B*E)``: the JAX package's three-operand einsum in a
    contraction order that is fixed, as one GEMM of ``B*E`` columns.  The
    result is a ``(B, O, E)`` view of the ``(O, B, E)`` product.
    """
    b, h, e = xk.shape
    n = x0.shape[1]
    o = weight.shape[0]
    z = xk.permute(1, 0, 2)[:, None] * x0.permute(1, 0, 2)[None]  # (H, N, B, E)
    out = torch.matmul(weight.reshape(o, h * n), z.reshape(h * n, b * e))
    return out.reshape(o, b, e).permute(1, 0, 2)


__all__ = ["afm_pairwise_products", "cin_interaction", "cross_layer",
           "ffm_pairwise_interaction", "fm_pairwise_interaction", "inner_product_pairs",
           "low_rank_cross", "outer_product_pairs"]
