"""DeepFM (Guo et al., IJCAI 2017), the forward pass in plain PyTorch.

``logit = sum(dense values) + sum_e FM(rows) + DNN(flat rows)``: the first
order is the raw dense values summed at weight 1 (the configuration's
first order, as the port's and the JAX package's DeepFM take it), the FM
term ``0.5 ((sum_n v_n)^2 - sum_n v_n^2)`` summed over the embedding axis,
and the tower of ReLU layers, each followed by dropout at the
configuration's rate, over the ``N*E`` flat rows to one output, with the
products in the configuration's precision.  No weight penalty: the paper
trains with dropout alone.
"""

from __future__ import annotations

from typing import Dict

import torch

from reference.precision import dense_bf16

TABLE = "inputs.schema.emb_inputs.embedding"


def forward(w: Dict[str, torch.Tensor], buffers, feat: torch.Tensor, rows_by_table: Dict,
            cfg: Dict, mode: str, dropout) -> torch.Tensor:
    """``(B, D)`` dense values and the ``(B, N, E)`` rows of :data:`TABLE`
    → ``(B, 1)`` logits in the rows' dtype; ``dropout`` drops a hidden
    layer's activations.  ``buffers`` is unused (DeepFM keeps no running
    statistics)."""
    del buffers
    rows = rows_by_table[TABLE]
    b = rows.shape[0]
    fm_first = feat.sum(dim=1, keepdim=True)
    summed = rows.sum(dim=1)
    fm_second = 0.5 * (summed * summed - (rows * rows).sum(dim=1))
    fm_out = fm_second.sum(dim=1, keepdim=True) + fm_first
    x = rows.reshape(b, -1)
    for i in range(len(cfg["deep_layer_sizes"])):
        x = dropout(torch.relu(dense_bf16(x, w[f"model.deep.dense_{i}.weight"],
                                          w[f"model.deep.dense_{i}.bias"], mode)))
    out = dense_bf16(x, w["model.deep.output.weight"], w["model.deep.output.bias"], mode)
    return out.to(fm_out.dtype) + fm_out


def penalty(w: Dict[str, torch.Tensor], cfg: Dict) -> float:
    del w, cfg
    return 0.0


__all__ = ["TABLE", "forward", "penalty"]
