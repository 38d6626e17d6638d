"""``dlrm_dcnv2_criteo1tb``: MLPerf Training's DLRM-DCNv2 at its published
sizes, its table row-sharded over four cards.

The program builds it as ``Pipeline(...).set_model("DLRM_DCNv2",
bottom_layer_sizes=(512, 256), cross_num_layers=3, cross_rank=512,
top_layer_sizes=(1024, 1024, 512, 256))`` over 13 dense values and one
``MultiHotIndicesEmbedding`` of the 26 multi-hot fields (204,184,588 rows at
E = 128, unallocated until the trainer lays it out), Adagrad on the table
and the dense parameters, ``set_sparse_embeddings(True)``,
``set_compute_dtype("bfloat16")`` and ``Trainer(steps_per_execution=2,
presort=False, mesh=make_mesh(1, 4), lookup_options={"strategy":
"psum"})``: each of the four ranks (``harness.mesh_run``) holds a quarter of
the table and its Adagrad state and runs the whole batch's tower.  The
sizes are in ``dlrm_dcnv2_criteo1tb.json``; the plain reference is
``reference/dlrm_dcnv2.py``.  The module's attributes are the hooks that
``harness.mesh_run`` calls.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

from harness import counts, weights
from harness.ctr import NORM_CHUNK_ROWS, sq_sum
from harness.mesh_run import MeshRun
from reference.dlrm_dcnv2 import TABLE
from reference.dlrm_dcnv2 import train as reference_train

MODEL = "DLRM_DCNv2"
INT64 = 8
ADAGRAD_OPS = 5       # operations of one Adagrad update of one element
CROSS_OPS = 6         # the cross's combine, forward and backward, an element


def make_run(cell, device, seed: int) -> MeshRun:
    return MeshRun(cell, device, seed)


def require_program() -> None:
    """Fail at once where the program lacks what the configuration needs
    (an older checkout)."""
    from torecsys_tpu_torch.inputs import MultiHotIndicesEmbedding  # noqa: F401
    from torecsys_tpu_torch.models.base import MODELS

    if MODEL not in MODELS:
        raise ImportError(f"the program registers no model {MODEL!r}")


def build_program(cfg: Dict, device, seed: int):
    """The program's ``Trainer`` on the mesh of ``cfg["mesh"]`` where a
    process group is up (on one device otherwise), its state initialized."""
    import torch
    import torch.distributed as dist

    from torecsys_tpu_torch import Inputs, Pipeline, Trainer, ValueInput
    from torecsys_tpu_torch.inputs import MultiHotIndicesEmbedding
    from torecsys_tpu_torch.parallel import make_mesh

    mesh = None
    if dist.is_available() and dist.is_initialized():
        mesh = make_mesh(cfg["mesh"]["data"], cfg["mesh"]["table"], device_type=device.type)
    fields = tuple(f"cat_{i}" for i in range(len(cfg["field_sizes"])))
    schema = {"feat_inputs": ValueInput(tuple(f"dense_{j}" for j in range(cfg["num_dense"]))),
              "emb_inputs": MultiHotIndicesEmbedding(cfg["embed_size"], cfg["field_sizes"],
                                                     cfg["hots"], fields,
                                                     init_std=cfg["table_init_std"],
                                                     device=device)}
    opt = cfg["optimizer"]
    pipeline = (Pipeline(device=device).set_objective("ctr").set_inputs(Inputs(schema))
                .set_model(MODEL, bottom_layer_sizes=tuple(cfg["bottom_layer_sizes"]),
                           cross_num_layers=cfg["cross_num_layers"], cross_rank=cfg["cross_rank"],
                           top_layer_sizes=tuple(cfg["top_layer_sizes"]))
                .set_criterion("BCEWithLogitsLoss")
                .set_optimizer(opt["name"], lr=opt["lr"],
                               initial_accumulator_value=opt["initial_accumulator_value"],
                               eps=opt["eps"])
                .set_sparse_embeddings(cfg["sparse_embeddings"])
                .set_compute_dtype(cfg["compute_dtype"]).set_target_fields("label"))
    trainer = Trainer(pipeline, log_every=10**9, seed=seed,
                      steps_per_execution=cfg["steps_per_execution"], presort=cfg["presort"],
                      mesh=mesh, lookup_options={"strategy": cfg["mesh"]["strategy"]})
    trainer.init_state()
    if device.type == "cuda":
        from harness.card import log

        table = trainer.pipeline.sequential.inputs.schema["emb_inputs"].embedding
        peak = torch.cuda.max_memory_allocated(device) / 1e9
        whole = sum(cfg["field_sizes"]) * cfg["embed_size"] * 4 / 1e9
        log(f"{device}: the trainer's state made; peak {peak:.3f} GB, the table's rows held "
            f"{table.numel() * 4 / 1e9:.3f} GB of {whole:.3f}")
    return trainer


def widths(cfg: Dict):
    """(bottom, top) layer widths, input first, output last."""
    n, e = len(cfg["field_sizes"]), cfg["embed_size"]
    return ([cfg["num_dense"], *cfg["bottom_layer_sizes"], e],
            [(n + 1) * e, *cfg["top_layer_sizes"], 1])


def weight_spec(cfg: Dict) -> Tuple[Dict, Dict]:
    """``(parameters, buffers)``: the tensors the benchmark makes, under the
    names the program gives them."""
    params = {TABLE: ((sum(cfg["field_sizes"]), cfg["embed_size"]),
                      ("table", cfg["table_init_std"]))}
    for tower, w in zip(("bottom", "top"), widths(cfg)):
        names = [f"dense_{i}" for i in range(len(w) - 2)] + ["output"]
        for name, a, b in zip(names, w, w[1:]):
            params[f"model.{tower}.{name}.weight"] = ((b, a), ("fan_in",))
            params[f"model.{tower}.{name}.bias"] = ((b,), ("zeros",))
    d, r = widths(cfg)[1][0], cfg["cross_rank"]
    for i in range(cfg["cross_num_layers"]):
        params[f"model.cross.v_{i}.weight"] = ((r, d), ("fan_in",))
        params[f"model.cross.u_{i}.weight"] = ((d, r), ("fan_in",))
        params[f"model.cross.u_{i}.bias"] = ((d,), ("zeros",))
    return params, {}


def _table_module(trainer):
    return trainer.pipeline.sequential.inputs.schema["emb_inputs"]


def owned_rows(trainer) -> Tuple[int, int]:
    """The logical rows ``[lo, hi)`` of the table this rank holds (the
    whole table on one device; E = 128 stores one logical row a row)."""
    module = _table_module(trainer)
    lay = module.row_layout
    if lay is None:
        return 0, module.embedding.shape[0]
    return lay.index * lay.shard_rows, (lay.index + 1) * lay.shard_rows


def _own_blocks(params: Dict, seed: int, device, lo: int, hi: int):
    """``(first row, block)`` of the seed's table blocks cut to ``[lo, hi)``."""
    (rows, embed), (_, std) = params[TABLE]
    index = weights.tables(params)[TABLE]
    for block in range(lo // weights.TABLE_BLOCK_ROWS,
                       -(-min(hi, rows) // weights.TABLE_BLOCK_ROWS)):
        t = weights.table_block(seed, index, block, rows, embed, std, device)
        b0 = block * weights.TABLE_BLOCK_ROWS
        a, b = max(b0, lo), min(b0 + t.shape[0], hi)
        yield a, t[a - b0:b - b0]
        del t


def load_weights(trainer, params: Dict, buffers: Dict, seed: int, device) -> None:
    """Write the weights of the spec into the program: each dense parameter
    by name; of the table this rank's rows alone, from the seed's blocks
    that cover them."""
    import torch

    held = dict(trainer.pipeline.sequential.named_parameters())
    if set(held) != set(params):
        raise ValueError(f"the program's parameters {sorted(held)} are not the configuration's "
                         f"{sorted(params)}")
    made = weights.make({**params, **buffers}, seed, device, with_tables=False)
    lo, hi = owned_rows(trainer)
    with torch.no_grad():
        for name, (shape, init) in params.items():
            target = held[name]
            if init[0] != "table":
                if tuple(target.shape) != tuple(shape):
                    raise ValueError(f"{name}: the program's shape {tuple(target.shape)}, the "
                                     f"configuration's {tuple(shape)}")
                target.copy_(made[name])
                continue
            table = target.detach()
            table[max(0, shape[0] - lo):].zero_()  # rows past the logical table
            for a, block in _own_blocks(params, seed, device, lo, hi):
                table[a - lo:a - lo + block.shape[0]].copy_(block)


def _table_sum(trainer, value: float) -> float:
    """``value`` summed over the table group where the table is row-sharded
    (itself where each rank holds the whole table)."""
    import torch

    lay = _table_module(trainer).row_layout
    if lay is None or not lay.sharded:
        return value
    t = torch.tensor([value], dtype=torch.float64, device=trainer.device)
    return float(trainer.mesh.all_reduce(t, "table")[0])


def program_grad_norms(trainer, params: Dict, cfg: Dict) -> Dict[str, float]:
    """Each leaf's gradient norm at the step just taken, the first, from its
    Adagrad state: with the accumulator at 0 it holds ``g**2``; the table's
    is summed in float64 by chunks of rows, then over the table group."""
    held = dict(trainer.pipeline.sequential.named_parameters())
    opt = trainer.state.opt_state
    out = {}
    for name in params:
        if name == TABLE:
            v = opt["sparse"][name]["v"]
            total = sum(float(v[lo:lo + NORM_CHUNK_ROWS].double().sum())
                        for lo in range(0, v.shape[0], NORM_CHUNK_ROWS))
            out[name] = math.sqrt(_table_sum(trainer, total))
            continue
        state = opt["dense"].state.get(held[name], {})
        sos = state.get("sum_of_squares")
        out[name] = 0.0 if sos is None else math.sqrt(float(sos.double().sum()))
    return out


def program_change_norms(trainer, params: Dict, seed: int, device) -> Dict[str, float]:
    """The norm of each leaf's change since the weights were written; the
    table's over this rank's rows against the seed's blocks, summed over the
    table group."""
    held = dict(trainer.pipeline.sequential.named_parameters())
    initial = weights.make(params, seed, device, with_tables=False)
    change = {}
    lo, hi = owned_rows(trainer)
    for name in params:
        t = held[name].detach()
        if name != TABLE:
            change[name] = math.sqrt(sq_sum(t - initial[name]))
            continue
        total = 0.0
        for a, block in _own_blocks(params, seed, device, lo, hi):
            total += sq_sum(t[a - lo:a - lo + block.shape[0]] - block)
        change[name] = math.sqrt(_table_sum(trainer, total))
    return change


def global_ids(cfg: Dict, batch: Dict[str, np.ndarray]) -> np.ndarray:
    """``(B, S)`` int64 logical rows of the table that ``batch`` reads."""
    offsets = np.concatenate([[0], np.cumsum(cfg["field_sizes"], dtype=np.int64)[:-1]])
    return np.concatenate([batch[f"cat_{i}"].astype(np.int64) + offsets[i]
                           for i in range(len(cfg["field_sizes"]))], axis=1)


def shard_rows(cfg: Dict) -> int:
    return sum(cfg["field_sizes"]) // cfg["mesh"]["table"]


def batch_stats(cfg: Dict, batch: Dict[str, np.ndarray]) -> Dict[str, int]:
    """The batch's ids and bags, its distinct rows, and rank 0's (the rows
    of its quarter): its ids and distinct rows."""
    ids = global_ids(cfg, batch)
    mine = ids[ids < shard_rows(cfg)]
    return {"ids": int(ids.size), "bags": int(ids.shape[0] * len(cfg["field_sizes"])),
            "rows": int(np.unique(ids).size), "rank0_ids": int(mine.size),
            "rank0_rows": int(np.unique(mine).size)}


def ops_per_step(cfg: Dict, batch: int, stats: Dict) -> Dict[str, float]:
    """Operations a step of one card, which runs the whole batch's tower at
    data 1, by the dtype they run in: the MLPs' and the cross's GEMMs in
    bf16; in float32 the cross's combine, the bag sums of rank 0's ids, the
    dense Adagrad and the rank's row update."""
    bottom, top = widths(cfg)
    d, r, layers = top[0], cfg["cross_rank"], cfg["cross_num_layers"]
    cross = 3.0 * layers * 2 * (2.0 * batch * d * r)
    dense = sum(math.prod(shape) for shape, _ in weight_spec(cfg)[0].values()) - math.prod(
        weight_spec(cfg)[0][TABLE][0])
    e = cfg["embed_size"]
    f32 = (CROSS_OPS * layers * batch * d + stats["rank0_ids"] * e + ADAGRAD_OPS * dense
           + ADAGRAD_OPS * stats["rank0_rows"] * e)
    return {"bfloat16": counts.tower_gemm_ops(batch, bottom) + counts.tower_gemm_ops(batch, top)
            + cross, "float32": f32}


def bytes_per_step(cfg: Dict, stats: Dict) -> Dict[str, float]:
    """Rank 0's bytes a step: the pooled gather (the int64 ids read, each of
    its distinct rows read once, the ``(B, N, E)`` sums written); the sparse
    update of its shard (the ``(B, N, E)`` bag gradients and the int32 ids
    read, each of its touched rows of the table and of Adagrad's ``v`` read
    and written)."""
    row = cfg["embed_size"] * counts.F32
    return {"bag_lookup": stats["ids"] * INT64 + stats["rank0_rows"] * row + stats["bags"] * row,
            "sparse_update": (stats["bags"] * row + stats["ids"] * counts.ID_BYTES
                              + 2 * 2 * stats["rank0_rows"] * row)}


__all__ = ["batch_stats", "build_program", "bytes_per_step", "global_ids", "load_weights",
           "make_run", "ops_per_step", "owned_rows", "program_change_norms",
           "program_grad_norms", "reference_train", "require_program", "weight_spec"]
