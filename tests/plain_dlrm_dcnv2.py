"""A plain PyTorch DLRM-DCNv2, free of the port and of JAX: the benchmark's
reference (``h100_bench/reference/dlrm_dcnv2.py``) without its harness,
at float64 throughout, for the port's CPU tests.

A step: the dense values through the bottom MLP (ReLU after every layer)
to one ``E``-wide row; each multi-hot field's bag of rows summed; ``x0``
the bottom row and the bag sums, flattened; low-rank cross layers ``x' =
x0 * (U (V x) + b) + x``; the top MLP (ReLU after each hidden layer) to one
logit; the mean binary cross-entropy with logits; then Adagrad in optax's
form, ``v += g**2``, ``p -= lr g / sqrt(v + eps)``, on every parameter and
on the table's rows (a row no slot reads takes a zero gradient, which
leaves it and its ``v`` as they are).

Parameters are a dict under the port's names: ``table`` the logical ``(V,
E)`` table; ``model.bottom.*``, ``model.cross.v_{i}.weight``,
``model.cross.u_{i}.weight``/``bias`` and ``model.top.*`` as the port's
``DLRMDCNv2Model`` names them.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

DTYPE = torch.float64
TABLE = "table"


def global_ids(batch: Dict[str, np.ndarray], field_sizes: Sequence[int]) -> np.ndarray:
    """``(B, S)`` int64 rows of the fused table, the fields' slots in order."""
    offsets = np.concatenate([[0], np.cumsum(field_sizes, dtype=np.int64)[:-1]])
    return np.concatenate([np.asarray(batch[f"cat_{i}"]).reshape(len(batch["label"]), -1)
                           .astype(np.int64) + offsets[i] for i in range(len(field_sizes))],
                          axis=1)


def bag_sums(table: torch.Tensor, ids: torch.Tensor, hots: Sequence[int]) -> torch.Tensor:
    """``(B, N, E)``: each field's bag of rows summed (ids outside the table
    add nothing)."""
    ok = (ids >= 0) & (ids < table.shape[0])
    rows = table[torch.where(ok, ids, torch.zeros_like(ids))] * ok[..., None].to(table.dtype)
    bounds = np.concatenate([[0], np.cumsum(hots)])
    return torch.stack([rows[:, a:b].sum(dim=1) for a, b in zip(bounds, bounds[1:])], dim=1)


def mlp(p: Dict[str, torch.Tensor], x: torch.Tensor, tower: str, hidden: int,
        relu_out: bool) -> torch.Tensor:
    for i in range(hidden):
        x = torch.relu(F.linear(x, p[f"model.{tower}.dense_{i}.weight"],
                                p[f"model.{tower}.dense_{i}.bias"]))
    x = F.linear(x, p[f"model.{tower}.output.weight"], p[f"model.{tower}.output.bias"])
    return torch.relu(x) if relu_out else x


def low_rank_cross(p: Dict[str, torch.Tensor], x0: torch.Tensor, layers: int) -> torch.Tensor:
    x = x0
    for i in range(layers):
        v = F.linear(x, p[f"model.cross.v_{i}.weight"])
        u = F.linear(v, p[f"model.cross.u_{i}.weight"], p[f"model.cross.u_{i}.bias"])
        x = x0 * u + x
    return x


def logits(p: Dict[str, torch.Tensor], batch: Dict[str, np.ndarray], cfg: Dict) -> torch.Tensor:
    """``(B, 1)`` logits of ``batch`` under the parameters ``p``."""
    ids = torch.from_numpy(global_ids(batch, cfg["field_sizes"]))
    pooled = bag_sums(p[TABLE], ids, cfg["hots"])
    b = pooled.shape[0]
    feat = torch.from_numpy(np.stack([batch[f"dense_{j}"] for j in range(cfg["num_dense"])],
                                     axis=1)).to(DTYPE)
    bottom = mlp(p, feat, "bottom", len(cfg["bottom"]), relu_out=True)
    x0 = torch.cat([bottom, pooled.reshape(b, -1)], dim=1)
    x = low_rank_cross(p, x0, cfg["cross_layers"])
    return mlp(p, x, "top", len(cfg["top"]), relu_out=False)


def step(p: Dict[str, torch.Tensor], v: Dict[str, torch.Tensor], batch: Dict[str, np.ndarray],
         cfg: Dict) -> Tuple[float, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One Adagrad step from ``(p, v)``: ``(loss, p', v')``, the inputs
    untouched."""
    leaves = {k: t.detach().clone().requires_grad_(True) for k, t in p.items()}
    label = torch.from_numpy(batch["label"]).to(DTYPE)[:, None]
    loss = F.binary_cross_entropy_with_logits(logits(leaves, batch, cfg), label)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    new_p, new_v = {}, {}
    with torch.no_grad():
        for (k, t), g in zip(p.items(), grads):
            new_v[k] = v[k] + g * g
            new_p[k] = t - cfg["lr"] * g / torch.sqrt(new_v[k] + cfg["eps"])
    return float(loss.detach()), new_p, new_v


__all__ = ["DTYPE", "TABLE", "bag_sums", "global_ids", "logits", "low_rank_cross", "mlp",
           "step"]
