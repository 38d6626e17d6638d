"""``deepfm_criteo``: DeepFM (Guo et al., IJCAI 2017) on Criteo's inputs.

The program builds it as ``Pipeline(...).set_model("DeepFM",
deep_layer_sizes=(400, 400, 400), deep_dropout_rate=0.5)`` over 13 dense
values and one fused table of Criteo's 26 categorical fields,
``set_sparse_embeddings(None)`` (the automatic choice: the on-device
sparse route on the card), ``set_compute_dtype("bfloat16")`` and
``Trainer(steps_per_execution=8)``: the port's headline path.  The sizes
are in ``deepfm_criteo.json``; the plain reference is
``reference/deepfm.py``.  The module's attributes are the hooks that
``harness.trainer_run`` calls.
"""

from __future__ import annotations

from typing import Dict, Tuple

from harness import counts
from harness.ctr import (batch_stats, criteo_program, load_weights, program_change_norms,
                         program_grad_norms)
from harness.trainer_run import TrainerRun
from reference.ctr import criteo_inputs
from reference.ctr import train as reference_train
from reference.deepfm import TABLE, forward, penalty

MODEL = "DeepFM"


def make_run(cell, device, seed: int) -> TrainerRun:
    return TrainerRun(cell, device, seed)


def build_program(cfg: Dict, device, seed: int):
    return criteo_program(cfg, MODEL, {"deep_layer_sizes": tuple(cfg["deep_layer_sizes"]),
                                       "deep_dropout_rate": cfg["dropout"]}, device, seed)


def reference_inputs(batch, cfg: Dict, device, rows: int):
    return criteo_inputs(batch, cfg, TABLE, device, rows)


def tower_widths(cfg: Dict):
    return [len(cfg["field_sizes"]) * cfg["embed_size"], *cfg["deep_layer_sizes"], 1]


def weight_spec(cfg: Dict) -> Tuple[Dict, Dict]:
    """``(parameters, buffers)``: the tensors the benchmark makes, under the
    names the program gives them."""
    params = {TABLE: ((sum(cfg["field_sizes"]), cfg["embed_size"]),
                      ("table", cfg["table_init_std"]))}
    widths = tower_widths(cfg)
    names = [f"dense_{i}" for i in range(len(widths) - 2)] + ["output"]
    for name, a, b in zip(names, widths, widths[1:]):
        params[f"model.deep.{name}.weight"] = ((b, a), ("fan_in",))
        params[f"model.deep.{name}.bias"] = ((b,), ("zeros",))
    return params, {}


def ops_per_step(cfg: Dict, batch: int, stats: Dict) -> Dict[str, float]:
    """Operations a step by the dtype they run in: the tower's GEMMs in
    bf16; the FM term (forward and backward, about six a row element), the
    dense Adam and the row update in float32."""
    widths = tower_widths(cfg)
    n, e = len(cfg["field_sizes"]), cfg["embed_size"]
    f32 = (6.0 * batch * n * e + counts.ADAM_OPS * counts.tower_params(widths)
           + counts.sparse_path_float32_ops(cfg, stats))
    return {"bfloat16": counts.tower_gemm_ops(batch, widths), "float32": f32}


def bytes_per_step(cfg: Dict, stats: Dict) -> Dict[str, float]:
    return {"lookup": counts.lookup_bytes(cfg, stats),
            "sparse_update": counts.sparse_update_bytes(cfg, stats)}


__all__ = ["batch_stats", "build_program", "bytes_per_step", "forward", "load_weights",
           "make_run", "ops_per_step", "penalty", "program_change_norms", "program_grad_norms",
           "reference_inputs", "reference_train", "weight_spec"]
