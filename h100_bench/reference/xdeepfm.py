"""xDeepFM (Lian et al., KDD 2018), the forward pass in plain PyTorch.

``logit = sum(dense values) + CIN(rows) + DNN(flat rows) + bias``.  The
CIN's layer ``k`` maps the previous map ``X^{k-1}`` ``(B, H', E)`` and the
base ``X^0`` ``(B, N, E)`` to ``Z^k[b, o, e] = sum_{h, n} W^k[o, h, n]
X^{k-1}[b, h, e] X^0[b, n, e]``, adds a bias per map, normalizes each map
over ``(B, E)`` by the batch's statistics (flax's ``BatchNorm``: biased
variance ``E[z^2] - E[z]^2``, epsilon 1e-5, running statistics at momentum
0.99), and applies ReLU.  Split-half: a layer but the last pools its first
``H/2`` maps and feeds the others forward; the last pools all.  The pooled
maps are summed over ``E`` and go through a linear head.  The CIN's
products are the configuration's float32 GEMMs (float64 in the reference,
``reference.ctr``); the head and the DNN follow its bf16 products.  The
loss adds ``l2_reg`` times the sum of squares of every dense layer's weight
matrix (the DNN's and the CIN's head), the paper's L2 penalty.
"""

from __future__ import annotations

from typing import Dict

import torch

from reference.precision import dense_bf16, matmul_f32

TABLE = "inputs.schema.emb_inputs.embedding"
BN_MOMENTUM = 0.99
BN_EPS = 1e-5


def _batch_norm(z, k: int, w, buffers, training: bool):
    if training:
        mean = z.mean(dim=(0, 2))
        var = torch.clamp_min((z * z).mean(dim=(0, 2)) - mean * mean, 0.0)
        with torch.no_grad():
            for name, value in (("mean", mean), ("var", var)):
                key = f"model.cin.bn_{k}.{name}"
                buffers[key].copy_(BN_MOMENTUM * buffers[key] + (1 - BN_MOMENTUM) * value)
    else:
        mean, var = buffers[f"model.cin.bn_{k}.mean"], buffers[f"model.cin.bn_{k}.var"]
    mul = torch.rsqrt(var + BN_EPS) * w[f"model.cin.bn_{k}.scale"]
    return (z - mean[:, None]) * mul[:, None] + w[f"model.cin.bn_{k}.bias"][:, None]


def cin(w, buffers, x0: torch.Tensor, cfg: Dict, mode: str, training: bool) -> torch.Tensor:
    b, n, e = x0.shape
    sizes = cfg["cin_layer_sizes"]
    xk, pooled = x0, []
    for k, h in enumerate(sizes):
        hp = xk.shape[1]
        # one GEMM: the (B*E, H'*N) outer products by the (H'*N, H) filters
        outer = (xk[:, :, None, :] * x0[:, None, :, :]).permute(0, 3, 1, 2)
        filters = w[f"model.cin.conv_{k}"].reshape(h, hp * n).t()
        z = matmul_f32(outer.reshape(b * e, hp * n), filters, mode)
        z = z.reshape(b, e, h).permute(0, 2, 1)  # (B, h, E)
        z = z + w[f"model.cin.bias_{k}"]
        z = torch.relu(_batch_norm(z, k, w, buffers, training))
        if k == len(sizes) - 1:
            pooled.append(z)
        else:
            pooled.append(z[:, :h // 2])
            xk = z[:, h // 2:]
    out = torch.cat(pooled, dim=1).sum(dim=2)
    return dense_bf16(out, w["model.cin.head.weight"], w["model.cin.head.bias"], mode)


def forward(w: Dict[str, torch.Tensor], buffers: Dict[str, torch.Tensor], feat: torch.Tensor,
            rows_by_table: Dict, cfg: Dict, mode: str, dropout) -> torch.Tensor:
    """``(B, D)`` dense values and the ``(B, N, E)`` rows of :data:`TABLE`
    → ``(B, 1)`` logits in the rows' dtype, in training: the BatchNorms'
    running statistics in ``buffers`` move in place; ``dropout`` drops a
    DNN layer's activations."""
    rows = rows_by_table[TABLE]
    b = rows.shape[0]
    cin_out = cin(w, buffers, rows, cfg, mode, True)
    x = rows.reshape(b, -1)
    for i in range(len(cfg["deep_layer_sizes"])):
        x = dropout(torch.relu(dense_bf16(x, w[f"model.deep.dense_{i}.weight"],
                                          w[f"model.deep.dense_{i}.bias"], mode)))
    deep_out = dense_bf16(x, w["model.deep.output.weight"], w["model.deep.output.bias"], mode)
    out = feat.sum(dim=1, keepdim=True) + cin_out + deep_out
    return out + w["model.bias"]


def penalty(w: Dict[str, torch.Tensor], cfg: Dict):
    """``l2_reg`` times the sum of squares of the dense layers' weight
    matrices."""
    kernels = [p for k, p in w.items()
               if k.endswith(".weight") and k.startswith(("model.deep.", "model.cin.head."))]
    return cfg["l2_reg"] * sum(torch.sum(p * p) for p in kernels)


__all__ = ["TABLE", "cin", "forward", "penalty"]
