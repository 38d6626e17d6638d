"""DLRM-DCNv2, the reference's training steps in plain PyTorch, and their
readings.

A step, as torchrec's ``DLRM_DCN`` and MLPerf's reference compute it: the
dense values through the bottom MLP (ReLU after every layer) to one
``E``-wide row; each multi-hot field's bag of rows summed; ``x0`` the
bottom row and the ``N`` bag sums, flattened; ``num_layers`` low-rank cross
layers ``x' = x0 * (U (V x) + b) + x``; the top MLP (ReLU after each hidden
layer) to one logit; the mean binary cross-entropy with logits; its
gradients by autograd over the whole batch on one device; then Adagrad on
every dense parameter and on the table's rows: ``v += g**2``, ``p -= lr g /
sqrt(v + eps)`` (optax's form, the accumulator from
``initial_accumulator_value``).  Only the table's rows that the steps touch
are held, made from the seed's blocks (``initial_rows``); a row that a step
does not touch takes a zero gradient, which leaves it and its ``v`` as they
are, as the program's lazy row update leaves them.

What the configuration states in float32 (the table, the bag sums, the
cross's combine, the loss, the optimizer) the reference computes in float64
(:data:`DTYPE`); what it states in bf16 (the products of the MLPs and the
cross, forward and backward) it rounds to bf16 as the configuration does
(``reference.precision.dense_bf16``: autograd takes the backward's products
in bf16 too, rounded to bf16).

``mode`` ``control`` is one precision step below, forward and backward
(:func:`dense_layer`): the products' operands in fp8 as fp8 training takes them,
e4m3 for the activations and the weights (``reference.precision.fp8``) and
e5m2 for the gradient that the backward's products take (:func:`e5m2`),
each product rounded to bf16; the rows read from the table rounded to bf16
(``reference.precision.table_rows``).  ``precision.dense_bf16``'s own
control lowers the forward alone and runs the backward's products in
float32, above the bf16 that the configuration states for them.

The readings (:func:`train`): the loss of each step, each leaf's gradient
norm at the first step, and the norm of each leaf's change after the last
step.  ``fault`` plants one of :data:`FAULTS`: those of ``reference.ctr``,
and ``no_exchange``, the psum of the bag sums left out, so that rank 0's
sums hold the rows of its own quarter of the table alone
(:func:`shard_rows`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from reference.precision import dense_bf16, fp8, table_rows

DTYPE = torch.float64
TABLE = "inputs.schema.emb_inputs.embedding"
FAULTS = (None, "unchanged", "half_batch", "altered_loss", "stale_rows", "no_exchange")
ALTERED_LOSS = 1e-2
E5M2_MAX = 57344.0


def norm(x: torch.Tensor) -> float:
    """The 2-norm of ``x``, summed in float64."""
    return math.sqrt(float(torch.sum(torch.square(x.detach().double()))))


def global_ids(batch: Dict[str, np.ndarray], cfg: Dict) -> np.ndarray:
    """``(B, S)`` int64 logical rows of the fused table: each field's ids
    shifted by the sizes of the fields before it, the fields' slots in
    order."""
    offsets = np.concatenate([[0], np.cumsum(cfg["field_sizes"], dtype=np.int64)[:-1]])
    return np.concatenate([batch[f"cat_{i}"].astype(np.int64) + offsets[i]
                           for i in range(len(cfg["field_sizes"]))], axis=1)


def shard_rows(cfg: Dict) -> int:
    """The logical rows of one table rank's quarter: rank 0 holds ``[0,
    shard_rows)``."""
    return sum(cfg["field_sizes"]) // cfg["mesh"]["table"]


def e5m2(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded through float8 e5m2 at one scale, its largest
    magnitude onto e5m2's largest: fp8 training's gradient format."""
    scale = t.abs().amax().clamp_min(1e-30) / E5M2_MAX
    return (t / scale).to(torch.float8_e5m2).to(t.dtype) * scale


class _Fp8Product(torch.autograd.Function):
    """``x W^T`` of fp8 operands (float32 tensors that hold e4m3 values),
    rounded to bf16; its backward takes the incoming gradient through
    :func:`e5m2` and rounds each of its two products to bf16."""

    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return F.linear(x, weight).to(torch.bfloat16)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        g = e5m2(grad.float())
        return ((g @ weight).to(torch.bfloat16).to(x.dtype),
                (g.t() @ x).to(torch.bfloat16).to(weight.dtype))


def dense_layer(x: torch.Tensor, weight: torch.Tensor, bias, mode: str) -> torch.Tensor:
    """A layer whose products the configuration states in bf16; the output
    is bf16.  ``stated``: ``reference.precision.dense_bf16``; ``control``:
    one step below, forward and backward (see the module's docstring), the
    bias added in bf16 as in ``stated``."""
    if mode == "stated":
        return dense_bf16(x, weight, bias, mode)
    y = _Fp8Product.apply(fp8(x.float()), fp8(weight))
    return y if bias is None else y + bias.to(torch.bfloat16)


def mlp(w: Dict[str, torch.Tensor], x: torch.Tensor, tower: str, hidden: int, mode: str,
        relu_out: bool) -> torch.Tensor:
    """A tower of ``hidden`` ReLU layers and an output layer (ReLU after it
    where ``relu_out``), each product in bf16."""
    for i in range(hidden):
        x = torch.relu(dense_layer(x, w[f"model.{tower}.dense_{i}.weight"],
                                   w[f"model.{tower}.dense_{i}.bias"], mode))
    x = dense_layer(x, w[f"model.{tower}.output.weight"], w[f"model.{tower}.output.bias"], mode)
    return torch.relu(x) if relu_out else x


def forward(w: Dict[str, torch.Tensor], feat: torch.Tensor, pooled: torch.Tensor, cfg: Dict,
            mode: str) -> torch.Tensor:
    """``(B, D)`` dense values and ``(B, N, E)`` bag sums → ``(B, 1)`` logits
    in float64."""
    b = pooled.shape[0]
    bottom = mlp(w, feat, "bottom", len(cfg["bottom_layer_sizes"]), mode, relu_out=True)
    x0 = torch.cat([bottom.to(DTYPE), pooled.reshape(b, -1)], dim=1)
    x = x0
    for i in range(cfg["cross_num_layers"]):
        v = dense_layer(x, w[f"model.cross.v_{i}.weight"], None, mode)
        u = dense_layer(v, w[f"model.cross.u_{i}.weight"], w[f"model.cross.u_{i}.bias"], mode)
        x = x0 * u.to(DTYPE) + x
    out = mlp(w, x, "top", len(cfg["top_layer_sizes"]), mode, relu_out=False)
    return out.to(DTYPE)


def bag_sums(rows: torch.Tensor, hots: Sequence[int]) -> torch.Tensor:
    """``(B, S, E)`` slot rows → ``(B, N, E)`` sums of each field's bag."""
    bounds = np.concatenate([[0], np.cumsum(hots)])
    return torch.stack([rows[:, a:b].sum(dim=1) for a, b in zip(bounds, bounds[1:])], dim=1)


class Adagrad:
    """optax's Adagrad over tensors, in place: ``v += g**2``, ``p -= lr g /
    sqrt(v + eps)``."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, initial: float, eps: float):
        self.params = params
        self.v = {k: torch.full_like(p, initial) for k, p in params.items()}
        self.lr, self.eps = lr, eps

    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        with torch.no_grad():
            for k, p in self.params.items():
                g = grads[k]
                self.v[k].add_(g * g)
                p.sub_(self.lr * g / torch.sqrt(self.v[k] + self.eps))


def train(dense: Dict[str, torch.Tensor], initial_rows: Callable[[torch.Tensor], torch.Tensor],
          batches: Sequence[Dict[str, np.ndarray]], cfg: Dict, mode: str = "stated",
          fault=None) -> Dict:
    """Train from the dense weights ``dense`` (float32, consumed) and the
    table whose initial rows ``initial_rows(ids)`` gives (``(U, E)`` float32
    of sorted unique logical ids), on ``batches``, one step each, in
    ``mode``; ``fault`` plants one of :data:`FAULTS`.  Returns the readings
    (see the module's docstring)."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    opt = cfg["optimizer"]
    hyper = (opt["lr"], opt["initial_accumulator_value"], opt["eps"])
    device = next(iter(dense.values())).device
    ids = [torch.from_numpy(global_ids(b, cfg)).to(device) for b in batches]
    uniq = torch.unique(torch.cat([i.reshape(-1) for i in ids]))
    start = initial_rows(uniq)
    table = {TABLE: start.to(DTYPE)}
    params = {k: p.to(DTYPE) for k, p in dense.items()}
    dense.clear()
    initial = {k: p.clone() for k, p in params.items()}
    adagrad = Adagrad({**table, **params}, *hyper)
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    k = cfg["steps_per_execution"]
    for t, batch in enumerate(batches, start=1):
        at = t - 1
        if fault == "stale_rows":  # every step of a dispatch reads its first batch
            at = (t - 1) // k * k
        batch = batches[at]
        n = len(batch["label"])
        n = n // 2 if fault == "half_batch" else n
        rows = table[TABLE].detach().requires_grad_(True)
        w = {kk: p.detach().requires_grad_(True) for kk, p in params.items()}
        slots = torch.searchsorted(uniq, ids[at][:n])
        read = table_rows(rows[slots], mode)
        if fault == "no_exchange":  # rank 0's own rows alone, no psum
            read = read * (ids[at][:n] < shard_rows(cfg))[..., None].to(read.dtype)
        pooled = bag_sums(read, cfg["hots"])
        feat = torch.from_numpy(np.stack([batch[f"dense_{j}"][:n]
                                          for j in range(cfg["num_dense"])], axis=1))
        label = torch.from_numpy(batch["label"][:n]).to(device, DTYPE)[:, None]
        logits = forward(w, feat.to(device, DTYPE), pooled, cfg, mode)
        loss = F.binary_cross_entropy_with_logits(logits, label)
        grads = torch.autograd.grad(loss, [rows, *w.values()])
        del pooled, logits
        losses.append(float(loss.detach()) + (ALTERED_LOSS if fault == "altered_loss" else 0.0))
        named = {TABLE: grads[0], **dict(zip(w, grads[1:]))}
        if t == 1:
            grad_norms = {kk: norm(g) for kk, g in named.items()}
            if fault == "unchanged":  # its optimizer state stays at nought
                grad_norms = dict.fromkeys(grad_norms, 0.0)
        if fault == "unchanged":
            continue
        adagrad.step(named)
    with torch.no_grad():
        change = {kk: norm(p - initial[kk]) for kk, p in params.items()}
        change[TABLE] = norm(table[TABLE] - start.to(DTYPE))
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


__all__ = ["ALTERED_LOSS", "Adagrad", "DTYPE", "FAULTS", "TABLE", "bag_sums", "dense_layer", "e5m2",
           "forward", "global_ids", "mlp", "norm", "shard_rows", "train"]
