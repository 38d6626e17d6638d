"""The reference's training steps of a CTR configuration, and its readings.

A step: each table's rows of the batch's ids from its logical ``(V, E)``
table, the model's logits (the configuration's ``forward``), the mean
binary cross-entropy with logits plus the configuration's weight penalty
(``penalty``), its gradients by autograd; then Adam on every dense
parameter and the lazy row-wise Adam on each table.  The row-wise Adam works
on stored rows of ``P`` logical rows (the configuration's
``rows_per_stored_row``): a stored row that any id of the batch touches
takes the update, with a zero gradient in its untouched logical rows; the
others and their moments stay as they are.  Its bias correction counts the
global step, ``t = step + 1``.

What the configuration states in float32 the reference computes in float64
(:data:`DTYPE`): so a leaf whose true gradient is nought, as a bias ahead of
a BatchNorm is, reads nought to float64's rounding, far under any leaf that
learns.  What it states in bf16 (the towers' products) the reference rounds
to bf16 as the configuration does (``reference.precision``).

Dropout (:class:`Dropout`) keeps what torch's own dropout keeps: the run
seeds torch's generators with the same seed before the program's first
compared step and before the reference's, and each dropout of the
reference draws its mask by calling ``torch.nn.functional.dropout`` on ones
of the program's shape and dtype, on the same device, in the program's
order.  The masks are torch's draws from the benchmark's seed; nothing is
read from the program.

The readings (:func:`train`): the loss of each step, each leaf's gradient
norm at the first step, and the norm of each leaf's change after the last
step.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from reference.precision import table_rows

DTYPE = torch.float64
FAULTS = (None, "unchanged", "half_batch", "altered_loss", "stale_rows")
ALTERED_LOSS = 1e-2


def norm(x: torch.Tensor) -> float:
    """The 2-norm of ``x``, summed in float64."""
    return math.sqrt(float(torch.sum(torch.square(x.detach().double()))))


def criteo_inputs(batch: Dict[str, np.ndarray], cfg: Dict, table: str, device, rows: int):
    """``({table: (B, N) global ids}, (B, D) dense values, (B, 1) labels)``
    of the first ``rows`` examples of a batch of ``cat_{i}``, ``dense_{j}``
    and ``label`` arrays, the fields fused into one table."""
    n = len(cfg["field_sizes"])
    offsets = np.concatenate([[0], np.cumsum(cfg["field_sizes"], dtype=np.int64)[:-1]])
    ids = np.stack([batch[f"cat_{i}"] for i in range(n)], axis=1).astype(np.int64) + offsets
    feat = np.stack([batch[f"dense_{j}"] for j in range(cfg["num_dense"])], axis=1)
    take = slice(0, rows)
    return ({table: torch.from_numpy(ids[take]).to(device)},
            torch.from_numpy(feat[take]).to(device, DTYPE),
            torch.from_numpy(batch["label"][take]).to(device, DTYPE)[:, None])


class Dropout:
    """Training dropout at rate ``p`` with torch's masks (see the module's
    docstring): ``x`` times the mask that ``F.dropout`` leaves on ones of
    ``x``'s shape in ``dtype``, the program's activation dtype."""

    def __init__(self, p: float, dtype: torch.dtype):
        self.p, self.dtype = p, dtype

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.p == 0.0:
            return x
        ones = torch.ones(x.shape, dtype=self.dtype, device=x.device)
        return x * F.dropout(ones, self.p, training=True).to(x.dtype)


class RowAdam:
    """The lazy row-wise Adam of a logical ``(V, E)`` table over stored rows
    of ``P`` logical rows, in place."""

    def __init__(self, table: torch.Tensor, pack: int, lr: float, b1: float, b2: float,
                 eps: float):
        v, e = table.shape
        self.pack, self.embed = pack, e
        stored = -(-v // pack)
        self.wide = torch.zeros((stored, pack * e), dtype=DTYPE, device=table.device)
        self.wide.view(-1, e)[:v].copy_(table)
        self.rows = v
        self.m = torch.zeros_like(self.wide)
        self.v = torch.zeros_like(self.wide)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def logical(self) -> torch.Tensor:
        return self.wide.view(-1, self.embed)[:self.rows]

    def gradient(self, ids: torch.Tensor, grads: torch.Tensor):
        """The touched stored rows and their ``(U, P*E)`` summed gradients."""
        flat = ids.reshape(-1)
        uniq, inv = torch.unique(flat // self.pack, return_inverse=True)
        g = torch.zeros((uniq.shape[0], self.pack, self.embed), dtype=DTYPE, device=ids.device)
        g.index_put_((inv, flat % self.pack), grads.reshape(-1, self.embed), accumulate=True)
        return uniq, g.reshape(uniq.shape[0], -1)

    def step(self, uniq: torch.Tensor, g: torch.Tensor, t: int) -> None:
        bc1 = 1.0 / (1.0 - self.b1 ** t)
        bc2 = 1.0 / (1.0 - self.b2 ** t)
        m = self.b1 * self.m[uniq] + (1.0 - self.b1) * g
        v = self.b2 * self.v[uniq] + (1.0 - self.b2) * g * g
        self.wide[uniq] -= self.lr * ((m * bc1) / (torch.sqrt(v * bc2) + self.eps))
        self.m[uniq] = m
        self.v[uniq] = v


class Adam:
    """Adam over dense tensors: ``p -= lr m_hat / (sqrt(v_hat) + eps)``."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, b1: float, b2: float,
                 eps: float):
        self.params = params
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def step(self, grads: Dict[str, torch.Tensor], t: int) -> None:
        with torch.no_grad():
            for k, p in self.params.items():
                g = grads[k]
                self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
                self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
                m_hat = self.m[k] / (1.0 - self.b1 ** t)
                v_hat = self.v[k] / (1.0 - self.b2 ** t)
                p.sub_(self.lr * m_hat / (torch.sqrt(v_hat) + self.eps))


def train(model, weights: Dict[str, torch.Tensor], buffers: Dict[str, torch.Tensor],
          table_names: Sequence[str], batches: Sequence[Dict[str, np.ndarray]], cfg: Dict,
          mode: str, initial_tables: Dict[str, Callable], rng_seed: int, fault=None) -> Dict:
    """Train from ``weights`` (consumed: the tensors move in place) and
    ``buffers`` on ``batches``, one step each, in ``mode``; ``fault`` plants
    one of :data:`FAULTS`.  ``model`` is the configuration's module:
    ``reference_inputs(batch, cfg, device, rows)``, ``forward(dense,
    buffers, inputs, rows_by_table, cfg, mode, dropout)`` and
    ``penalty(dense, cfg)``.  ``initial_tables[name]()`` yields ``(first
    row, rows)`` blocks of a table's initial values, for the norm of its
    change; ``rng_seed`` seeds torch's generators for the dropout masks.
    Returns the readings (see the module's docstring)."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    opt = cfg["optimizer"]
    hyper = (opt["lr"], opt["b1"], opt["b2"], opt["eps"])
    tables = {name: RowAdam(weights.pop(name), cfg["rows_per_stored_row"], *hyper)
              for name in table_names}
    dense = {k: p.to(DTYPE).requires_grad_(True) for k, p in weights.items()}
    weights.clear()
    buffers = {k: b.to(DTYPE) for k, b in buffers.items()}
    initial = {k: p.detach().clone() for k, p in dense.items()}
    initial_buffers = {k: b.clone() for k, b in buffers.items()}
    adam = Adam(dense, *hyper)
    device = next(iter(tables.values())).wide.device
    dropout = Dropout(cfg.get("dropout", 0.0), getattr(torch, cfg["compute_dtype"]))
    torch.manual_seed(rng_seed)
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    k = cfg["steps_per_execution"]
    for t, batch in enumerate(batches, start=1):
        if fault == "stale_rows":  # every step of a dispatch reads its first batch
            batch = batches[(t - 1) // k * k]
        n = len(batch["label"])
        ids, inputs, label = model.reference_inputs(batch, cfg, device,
                                                    n // 2 if fault == "half_batch" else n)
        rows = {name: tables[name].logical()[ids[name]].requires_grad_(True) for name in tables}
        logits = model.forward(dense, buffers, inputs,
                               {name: table_rows(r, mode) for name, r in rows.items()},
                               cfg, mode, dropout)
        loss = F.binary_cross_entropy_with_logits(logits, label) + model.penalty(dense, cfg)
        grads = torch.autograd.grad(loss, [*rows.values(), *dense.values()])
        losses.append(float(loss.detach()) + (ALTERED_LOSS if fault == "altered_loss" else 0.0))
        table_grads = {name: tables[name].gradient(ids[name], g)
                       for name, g in zip(tables, grads[:len(tables)])}
        dense_grads = dict(zip(dense, grads[len(tables):]))
        if t == 1:
            grad_norms = {name: norm(g) for name, (_, g) in table_grads.items()}
            grad_norms.update({k: norm(g) for k, g in dense_grads.items()})
            if fault == "unchanged":  # its optimizer state stays at nought
                grad_norms = dict.fromkeys(grad_norms, 0.0)
        if fault == "unchanged":  # a step that keeps its state
            for k, b in buffers.items():
                b.copy_(initial_buffers[k])
            continue
        adam.step(dense_grads, t)
        for name, (uniq, g) in table_grads.items():
            tables[name].step(uniq, g, t)
    with torch.no_grad():
        change = {k: norm(p - initial[k]) for k, p in dense.items()}
        for name, table in tables.items():
            logical = table.logical()
            total = 0.0
            for lo, block in initial_tables[name]():
                total += norm(logical[lo:lo + block.shape[0]] - block) ** 2
                del block
            change[name] = math.sqrt(total)
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


__all__ = ["ALTERED_LOSS", "Adam", "DTYPE", "Dropout", "FAULTS", "RowAdam", "criteo_inputs",
           "norm", "train"]
