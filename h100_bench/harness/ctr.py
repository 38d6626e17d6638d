"""What the CTR configurations share: the program built over Criteo's
inputs, the benchmark's weights written into it, the program's readings of
the comparison (the first step's gradient norms, the changes), and the
counts of a batch.

A configuration's module (``configs/<name>.py``) takes these as its own
hooks (:mod:`harness.trainer_run` calls them through it), or brings others:
a configuration of another schema, table layout or optimizer writes its own
``build_program``, ``load_weights``, ``program_grad_norms``,
``program_change_norms`` or ``batch_stats``, and nothing here changes.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from harness import weights

NORM_CHUNK_ROWS = 1 << 18
# where a dense optimizer keeps its first moment: torch's Adam, optax's names
FIRST_MOMENT_KEYS = ("exp_avg", "mu", "m")


def sq_sum(x) -> float:
    """The sum of squares of a 2-D (or 1-D) tensor in float64, by chunks of
    rows, so that no float64 copy of a table is ever whole."""
    import torch

    x = x.detach()
    if x.dim() < 2 or x.shape[0] <= NORM_CHUNK_ROWS:
        return float(torch.sum(torch.square(x.double())))
    return sum(float(torch.sum(torch.square(x[lo:lo + NORM_CHUNK_ROWS].double())))
               for lo in range(0, x.shape[0], NORM_CHUNK_ROWS))


def criteo_program(cfg: Dict, model: str, model_kwargs: Dict, device, seed: int):
    """The program's ``Trainer`` of a CTR model over ``num_dense`` dense
    values and one fused table of ``field_sizes`` categorical fields, with
    the configuration's route, compute dtype, optimizer, L2 penalty and K,
    its state initialized."""
    from torecsys_tpu_torch import Inputs, Pipeline, Trainer, ValueInput
    from torecsys_tpu_torch.inputs import MultiIndicesEmbedding

    fields = tuple(f"cat_{i}" for i in range(len(cfg["field_sizes"])))
    schema = {"feat_inputs": ValueInput(tuple(f"dense_{j}" for j in range(cfg["num_dense"]))),
              "emb_inputs": MultiIndicesEmbedding(cfg["embed_size"], cfg["field_sizes"], fields,
                                                  device=device)}
    opt = cfg["optimizer"]
    pipeline = (Pipeline(device=device).set_objective("ctr").set_inputs(Inputs(schema))
                .set_model(model, **model_kwargs)
                .set_criterion("BCEWithLogitsLoss").set_optimizer(opt["name"], lr=opt["lr"])
                .set_sparse_embeddings(cfg["sparse_embeddings"])
                .set_compute_dtype(cfg["compute_dtype"]).set_target_fields("label"))
    if cfg.get("l2_reg", 0.0):
        pipeline.set_regularizer(weight_decay=cfg["l2_reg"], norm=2, key_filter="kernel")
    trainer = Trainer(pipeline, log_every=10**9, seed=seed,
                      steps_per_execution=cfg["steps_per_execution"], presort=cfg["presort"])
    trainer.init_state()
    return trainer


def load_weights(trainer, params: Dict, buffers: Dict, seed: int, device) -> None:
    """Write the weights of the spec into the program: each parameter and
    buffer by name, each table through its logical ``(rows, E)`` view, block
    by block.  Every parameter of the program must come from the spec."""
    import torch

    seq = trainer.pipeline.sequential
    held = dict(seq.named_parameters())
    held_buffers = dict(seq.named_buffers())
    if set(held) != set(params):
        raise ValueError(f"the program's parameters {sorted(held)} are not the configuration's "
                         f"{sorted(params)}")
    made = weights.make({**params, **buffers}, seed, device, with_tables=False)
    with torch.no_grad():
        for name, (shape, init) in {**params, **buffers}.items():
            target = held.get(name, held_buffers.get(name))
            if target is None:
                raise ValueError(f"the program has no tensor {name!r}")
            if init[0] != "table":
                if tuple(target.shape) != tuple(shape):
                    raise ValueError(f"{name}: the program's shape {tuple(target.shape)}, the "
                                     f"configuration's {tuple(shape)}")
                target.copy_(made[name])
                continue
            rows, embed = shape
            logical = target.detach().view(-1, embed)
            if logical.shape[0] < rows:
                raise ValueError(f"{name}: {logical.shape[0]} logical rows, the configuration "
                                 f"has {rows}")
            for lo, block in weights.initial_blocks(params, name, seed, device)():
                logical[lo:lo + block.shape[0]].copy_(block)
                del block
            logical[rows:].zero_()


def _first_moment(trainer, name: str, param, is_table: bool):
    opt = trainer.state.opt_state
    if is_table:
        slots = opt["sparse"][name]
        if "mv" in slots:  # m and v of each stored row side by side
            return slots["mv"].reshape(-1, 2, slots["mv"].shape[-1])[:, 0]
        return slots.get("m")
    state = opt["dense"].state.get(param, {})
    return next((state[key] for key in FIRST_MOMENT_KEYS if key in state), None)


def program_grad_norms(trainer, params: Dict, cfg: Dict) -> Dict[str, float]:
    """Each leaf's gradient norm at the step just taken, the first, from its
    Adam state: the first moment is then ``(1 - b1) g``."""
    held = dict(trainer.pipeline.sequential.named_parameters())
    scale = 1.0 / (1.0 - cfg["optimizer"]["b1"])
    out = {}
    for name, (_, init) in params.items():
        m = _first_moment(trainer, name, held[name], init[0] == "table")
        out[name] = 0.0 if m is None else math.sqrt(sq_sum(m)) * scale
    return out


def program_change_norms(trainer, params: Dict, seed: int, device) -> Dict[str, float]:
    """The norm of each leaf's change since the weights were written, the
    tables' block by block against their initial blocks made again from the
    seed."""
    held = dict(trainer.pipeline.sequential.named_parameters())
    initial = weights.make(params, seed, device, with_tables=False)
    change = {}
    for name, (shape, init) in params.items():
        t = held[name].detach()
        if init[0] != "table":
            change[name] = math.sqrt(sq_sum(t - initial[name]))
            continue
        logical = t.view(-1, shape[1])
        total = 0.0
        for lo, block in weights.initial_blocks(params, name, seed, device)():
            total += sq_sum(logical[lo:lo + block.shape[0]] - block)
            del block
        change[name] = math.sqrt(total)
    return change


def global_ids(batch: Dict[str, np.ndarray], field_sizes) -> np.ndarray:
    """``(B, N)`` int64 rows of the fused table that ``batch`` reads: each
    field's ids shifted by the sizes of the fields before it."""
    offsets = np.concatenate([[0], np.cumsum(field_sizes, dtype=np.int64)[:-1]])
    cats = np.stack([batch[f"cat_{i}"] for i in range(len(field_sizes))], axis=1)
    return cats.astype(np.int64) + offsets[None, :]


def batch_stats(cfg: Dict, batch: Dict[str, np.ndarray]) -> Dict[str, int]:
    """The batch's ids, distinct logical rows and distinct stored rows of
    the fused table."""
    ids = global_ids(batch, cfg["field_sizes"])
    return {"ids": int(ids.size), "logical_rows": int(np.unique(ids).size),
            "stored_rows": int(np.unique(ids // cfg["rows_per_stored_row"]).size)}


__all__ = ["batch_stats", "criteo_program", "global_ids", "load_weights",
           "program_change_norms", "program_grad_norms", "sq_sum"]
