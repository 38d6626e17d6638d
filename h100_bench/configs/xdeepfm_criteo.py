"""``xdeepfm_criteo``: xDeepFM (Lian et al., KDD 2018, section 4) on the same
Criteo inputs as ``deepfm_criteo``.

The program builds it as ``Pipeline(...).set_model("xDeepFM",
cin_layer_sizes=(200, 200, 200), deep_layer_sizes=(400, 400),
cin_is_direct=False, use_batchnorm=True)`` with the same inputs, route,
bf16 tower and optimizer as ``deepfm_criteo``, the paper's L2 penalty on
the dense layers' kernels (``set_regularizer``), at 4 steps a dispatch.
The CIN computes in float32 (TF32 off), its head and the DNN in bf16.  The
sizes are in ``xdeepfm_criteo.json``; the plain reference is
``reference/xdeepfm.py``.  The module's attributes are the hooks that
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
from reference.xdeepfm import TABLE, forward, penalty

MODEL = "xDeepFM"
BN_OPS = 20           # a BatchNorm's forward and backward, a map element


def make_run(cell, device, seed: int) -> TrainerRun:
    return TrainerRun(cell, device, seed)


def build_program(cfg: Dict, device, seed: int):
    kwargs = {"cin_layer_sizes": tuple(cfg["cin_layer_sizes"]),
              "deep_layer_sizes": tuple(cfg["deep_layer_sizes"]),
              "cin_is_direct": cfg["cin_is_direct"], "use_batchnorm": cfg["use_batchnorm"],
              "deep_dropout_rate": cfg["dropout"]}
    return criteo_program(cfg, MODEL, kwargs, device, seed)


def reference_inputs(batch, cfg: Dict, device, rows: int):
    return criteo_inputs(batch, cfg, TABLE, device, rows)


def _cin_maps(cfg: Dict):
    """``(H_k, H_{k-1})`` of each CIN layer (split-half), and the pooled width."""
    n = len(cfg["field_sizes"])
    out, prev, pooled = [], n, 0
    sizes = cfg["cin_layer_sizes"]
    for k, h in enumerate(sizes):
        out.append((h, prev))
        last = k == len(sizes) - 1
        pooled += h if last else h // 2
        prev = h if last else h - h // 2
    return out, pooled


def weight_spec(cfg: Dict) -> Tuple[Dict, Dict]:
    """``(parameters, buffers)`` under the names the program gives them."""
    if cfg["cin_is_direct"] or not cfg["use_batchnorm"]:
        raise ValueError("the reference is the split-half CIN with BatchNorm")
    n, e = len(cfg["field_sizes"]), cfg["embed_size"]
    params = {TABLE: ((sum(cfg["field_sizes"]), e), ("table", cfg["table_init_std"])),
              "model.bias": ((1, 1), ("zeros",))}
    buffers = {}
    maps, pooled = _cin_maps(cfg)
    for k, (h, prev) in enumerate(maps):
        params[f"model.cin.conv_{k}"] = ((h, prev, n), ("fan_in",))
        params[f"model.cin.bias_{k}"] = ((h, 1), ("zeros",))
        params[f"model.cin.bn_{k}.scale"] = ((h,), ("ones",))
        params[f"model.cin.bn_{k}.bias"] = ((h,), ("zeros",))
        buffers[f"model.cin.bn_{k}.mean"] = ((h,), ("zeros",))
        buffers[f"model.cin.bn_{k}.var"] = ((h,), ("ones",))
    params["model.cin.head.weight"] = ((1, pooled), ("fan_in",))
    params["model.cin.head.bias"] = ((1,), ("zeros",))
    widths = [n * e, *cfg["deep_layer_sizes"], 1]
    names = [f"dense_{i}" for i in range(len(widths) - 2)] + ["output"]
    for name, a, b in zip(names, widths, widths[1:]):
        params[f"model.deep.{name}.weight"] = ((b, a), ("fan_in",))
        params[f"model.deep.{name}.bias"] = ((b,), ("zeros",))
    return params, buffers


def ops_per_step(cfg: Dict, batch: int, stats: Dict) -> Dict[str, float]:
    """Operations a step by dtype: the CIN's GEMMs (forward, and twice that
    backward), outer products (one product forward, four operations
    backward, an element) and BatchNorms in float32; the DNN and the CIN's
    head in bf16; the dense Adam and the row update in float32."""
    n, e = len(cfg["field_sizes"]), cfg["embed_size"]
    maps, pooled = _cin_maps(cfg)
    f32 = 0.0
    for h, prev in maps:
        f32 += 3.0 * 2.0 * batch * e * h * prev * n
        f32 += 5.0 * batch * e * prev * n
        f32 += BN_OPS * batch * e * h
    widths = [n * e, *cfg["deep_layer_sizes"], 1]
    params = sum(h * prev * n + 3 * h for h, prev in maps) + counts.tower_params(widths)
    f32 += counts.ADAM_OPS * (params + pooled + 1) + counts.sparse_path_float32_ops(cfg, stats)
    bf16 = counts.tower_gemm_ops(batch, widths) + counts.tower_gemm_ops(batch, [pooled, 1])
    return {"bfloat16": bf16, "float32": f32}


def bytes_per_step(cfg: Dict, stats: Dict) -> Dict[str, float]:
    return {"lookup": counts.lookup_bytes(cfg, stats),
            "sparse_update": counts.sparse_update_bytes(cfg, stats)}


__all__ = ["batch_stats", "build_program", "bytes_per_step", "forward", "load_weights",
           "make_run", "ops_per_step", "penalty", "program_change_norms", "program_grad_norms",
           "reference_inputs", "reference_train", "weight_spec"]
