#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``torecsys_tpu_torch``).

Run from the root of the repository on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed 0] [--steps 20] [--out DIR] [--profile]

Phases (any failure raises and the exit code is not 0):

1. Build the port's CUDA kernels from ``torecsys_tpu_torch/csrc`` with nvcc.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes of the main path: one Criteo-scale batch (the workload of
   ``bench.py``: 28 Zipf(1.2) id fields over 32.9M fused rows, batch 4096,
   E=16) presorted by the port's ``Presorter``.  Prints each kernel's time,
   its plain version's time, the time of one PyTorch call computing the
   same function where there is one, and its bound.
3. Train the full-width DeepFM (tower 400-400-400, Adam 1e-3, sparse
   presorted embedding route) through the port's ``Trainer`` for ``--steps``
   steps; every kernel launch counter must equal the step count.  Then take
   3 more steps twice from one copied state, with the kernels and with their
   plain versions, and compare.

The second-to-last lines are a JSON object of the kernels exercised and the
card's name and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

# The main-path workload, as bench.py builds it (bench.py:43-71).
BATCH = 4096
EMBED = 16
FIELD_SIZES = tuple(
    [10_000_000, 5_000_000, 4_000_000, 3_000_000, 2_000_000, 2_000_000]
    + [1_000_000] * 6 + [200_000] * 4 + [20_000] * 4 + [1_000] * 4 + [100] * 4
)
NUM_DENSE = 13
TOWER = (400, 400, 400)

# H100 SXM published peaks (NVIDIA data sheet): HBM rate and float32 rate
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

SEGSUM_ATOL = 1e-5   # g is drawn on a 2^-10 grid: every partial sum is exact
UPDATE_ATOL = 1e-6
TRAIN_LOSS_RTOL = 1e-5
TRAIN_ROWS_ATOL = 1e-6
COMPARE_STEPS = 3
DEVICE = "cuda"


def make_batches(seed: int, n_batches: int):
    """Host batches exactly as ``bench.py:59-71`` makes them."""
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(n_batches):
        b = {}
        for i, v in enumerate(FIELD_SIZES):
            raw = rng.zipf(1.2, size=BATCH)
            b[f"cat_{i}"] = np.minimum(raw - 1, v - 1).astype(np.int32)
        for j in range(NUM_DENSE):
            b[f"dense_{j}"] = rng.normal(size=BATCH).astype(np.float32)
        b["label"] = (rng.uniform(size=BATCH) < 0.5).astype(np.float32)
        batches.append(b)
    return batches


def log(*parts):
    print(*parts, flush=True)


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    float32 operations over the card's float32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ---- phase 1 ---------------------------------------------------------------

def phase_build():
    from torecsys_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    path, report = kernels.build("sparse_update.cu")
    log(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")


# ---- phase 2 ---------------------------------------------------------------

def presorted_stream(batch, pack: int):
    """Presort one batch's fused id stream with the port's Presorter; returns
    (spec, aux dict of numpy arrays)."""
    from torecsys_tpu_torch.data.presort import AUX_NAMES, Presorter, PresortSpec
    from torecsys_tpu_torch.ops.embedding import field_offsets, packed_shape

    fields = tuple(f"cat_{i}" for i in range(len(FIELD_SIZES)))
    vp, _ = packed_shape(sum(FIELD_SIZES), EMBED, pack)
    spec = PresortSpec(fields, tuple(int(o) for o in field_offsets(FIELD_SIZES)), pack, vp,
                       sum(FIELD_SIZES))
    out = Presorter([spec])(batch)
    return spec, {n: out[spec.aux_key(n)] for n in AUX_NAMES}


def phase_kernels(batch, seed: int):
    import torch

    from torecsys_tpu_torch.ops.embedding import packed_shape
    from torecsys_tpu_torch.ops.kernels import sparse_update as K

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    m = BATCH * len(FIELD_SIZES)
    # Random per-slot grads on a 2^-10 grid: every partial sum of a segment is
    # exact in float32, so the kernel and the plain version must agree to the
    # bit whatever order they sum in.
    g = torch.randn(m, EMBED, device=dev, generator=gen).mul_(1024).round_().div_(1024)
    records = {}

    # -- widened segment-sum, pack 8 (main path) and pack 1 --
    seg_err = 0.0
    for pack in (8, 1):
        spec, aux = presorted_stream(batch, pack)
        order = torch.from_numpy(aux["order"]).to(dev)
        lo = torch.from_numpy(aux["lo"]).to(dev)
        seg = torch.from_numpy(aux["seg"]).to(dev)
        g_sorted = g.index_select(0, order)
        got = K.widen_segment_sum(g_sorted, lo, seg, pack)
        ref = K.widen_segment_sum_plain(g_sorted, lo, seg, pack)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        n_unique = int(aux["n_unique"][0])
        longest = int(np.bincount(aux["seg"]).max())
        log(f"[segsum] pack={pack} M={m} n_unique={n_unique} longest segment={longest} "
            f"max_abs_err={err:.3g} (atol {SEGSUM_ATOL})")
        if not err <= SEGSUM_ATOL:
            raise AssertionError(f"widen_segment_sum pack={pack} disagrees: {err}")
        seg_err = max(seg_err, err)
        if pack != 8:
            continue
        w = pack * EMBED
        kernel_ms = time_ms(lambda: K.widen_segment_sum(g_sorted, lo, seg, pack), 50)
        plain_ms = time_ms(lambda: K.widen_segment_sum_plain(g_sorted, lo, seg, pack), 20)
        wide = torch.zeros(m, pack, EMBED, device=dev)
        wide[torch.arange(m, device=dev), lo.long()] = g_sorted
        wide = wide.reshape(m, w)
        seg64 = seg.long()
        library_ms = time_ms(
            lambda: torch.zeros(m, w, device=dev).index_add_(0, seg64, wide), 50)
        bound_ms, bound_by = bound(m * EMBED * 4 + 2 * m * 4 + m * w * 4, m * EMBED)
        log(f"[segsum] kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} (torch.zeros(M,W).index_add_ on a pre-widened "
            f"stream, a near-yardstick) bound_us={bound_ms * 1e3:.2f} ({bound_by}) "
            f"n_unique={n_unique}")
        records["widen_segment_sum"] = dict(
            name="widen_segment_sum", route="cuda",
            source="torecsys_tpu_torch/csrc/sparse_update.cu",
            replaces="torecsys_tpu/ops/pallas/sparse_update.py:248",
            max_abs_err=seg_err, ms=kernel_ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
        gsum, uids = got, torch.from_numpy(aux["uids"]).to(dev)
        n_valid = n_unique
    records["widen_segment_sum"]["max_abs_err"] = seg_err

    # -- fused row-wise update, each rule, on a full-size table --
    rows, w = packed_shape(sum(FIELD_SIZES), EMBED)
    table0 = torch.empty(rows, w, device=dev).normal_(0.0, 0.01, generator=gen)
    touched = torch.zeros(rows, dtype=torch.bool, device=dev)
    touched[uids[:n_valid].long()] = True
    t = 11  # bias correction of step 11
    cases = [("adam", 0.0), ("adam", 1e-2), ("adagrad", 0.0), ("sgd", 0.0)]
    upd_err = 0.0
    for rule, wd in cases:
        if rule == "adam":
            slot0 = torch.empty(rows, 2, w, device=dev)
            slot0[:, 0].normal_(0.0, 1e-3, generator=gen)
            slot0[:, 1].uniform_(0.0, 1e-5, generator=gen)
            slots0 = [slot0]
            hyper = torch.tensor([1e-3, 0.9, 0.999, 1e-8, wd,
                                  1.0 / (1.0 - 0.9 ** t), 1.0 / (1.0 - 0.999 ** t)],
                                 dtype=torch.float32, device=dev)
        elif rule == "adagrad":
            slots0 = [torch.empty(rows, w, device=dev).uniform_(0.1, 1.0, generator=gen)]
            hyper = torch.tensor([1e-3, 0, 0, 1e-7, 0, 1, 1], dtype=torch.float32, device=dev)
        else:
            slots0 = []
            hyper = torch.tensor([1e-3, 0, 0, 0, 0, 1, 1], dtype=torch.float32, device=dev)
        tk, sk = table0.clone(), [s.clone() for s in slots0]
        tp, sp = table0.clone(), [s.clone() for s in slots0]
        K.fused_rowwise_update(uids, gsum, tk, sk, hyper, rule, n_valid)
        K.fused_rowwise_update_plain(uids, gsum, tp, sp, hyper, rule, n_valid)
        torch.cuda.synchronize()
        err = 0.0
        for got, ref, orig in [(tk, tp, table0)] + list(zip(sk, sp, slots0)):
            err = max(err, (got - ref).abs().max().item())
            changed = (got != orig).reshape(rows, -1).any(dim=1)
            if bool((changed & ~touched).any()):
                raise AssertionError(f"fused_rowwise_update {rule}: an untouched row changed")
        log(f"[update] rule={rule} wd={wd} n_valid={n_valid} max_abs_err={err:.3g} "
            f"(atol {UPDATE_ATOL}); untouched rows bit-identical")
        if not err <= UPDATE_ATOL:
            raise AssertionError(f"fused_rowwise_update {rule} disagrees: {err}")
        upd_err = max(upd_err, err)
        if rule == "adam" and wd == 0.0:
            kernel_ms = time_ms(
                lambda: K.fused_rowwise_update(uids, gsum, tk, sk, hyper, rule, n_valid), 50)
            plain_ms = time_ms(
                lambda: K.fused_rowwise_update_plain(uids, gsum, tp, sp, hyper, rule, n_valid),
                20)
            # per touched row: read uid, gsum, table and m||v; write table and m||v
            n_bytes = n_valid * (4 + w * 4 + 2 * (w * 4 + 2 * w * 4))
            bound_ms, bound_by = bound(n_bytes, n_valid * w * 14)
            log(f"[update] kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms=null (no single PyTorch call computes a row-wise Adam "
                f"update) bound_us={bound_ms * 1e3:.2f} ({bound_by}) n_unique={n_valid}")
            records["fused_rowwise_update"] = dict(
                name="fused_rowwise_update", route="cuda",
                source="torecsys_tpu_torch/csrc/sparse_update.cu",
                replaces="torecsys_tpu/ops/pallas/sparse_update.py:50",
                ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)
        del tk, sk, tp, sp, slots0
    records["fused_rowwise_update"]["max_abs_err"] = upd_err
    del table0, touched
    torch.cuda.empty_cache()
    return records


# ---- phase 3 ---------------------------------------------------------------

def build_trainer(seed: int):
    from torecsys_tpu_torch import Inputs, MultiIndicesEmbedding, Pipeline, Trainer, ValueInput

    inputs = Inputs({
        "feat_inputs": ValueInput(tuple(f"dense_{j}" for j in range(NUM_DENSE))),
        "emb_inputs": MultiIndicesEmbedding(
            EMBED, FIELD_SIZES, tuple(f"cat_{i}" for i in range(len(FIELD_SIZES))),
            device=DEVICE),
    })
    pipeline = (
        Pipeline(device=DEVICE).set_objective("ctr").set_inputs(inputs)
        .set_model("DeepFM", deep_layer_sizes=TOWER)
        .set_criterion("BCEWithLogitsLoss").set_optimizer("Adam", lr=1e-3)
        .set_sparse_embeddings(True).set_target_fields("label")
    )
    trainer = Trainer(pipeline, log_every=10**9, seed=seed)
    trainer.init_state()
    return trainer


def snapshot(trainer):
    seq = trainer.pipeline.sequential
    st = trainer.state
    return {
        "params": {n: p.detach().clone() for n, p in seq.named_parameters()},
        "adam": copy.deepcopy(st.opt_state["dense"].state_dict()),
        "slots": {k: {n: v.clone() for n, v in s.items()} for k, s in st.opt_state["sparse"].items()},
        "step": st.step.clone(),
    }


def restore(trainer, snap):
    import torch

    seq = trainer.pipeline.sequential
    st = trainer.state
    with torch.no_grad():
        for n, p in seq.named_parameters():
            p.copy_(snap["params"][n])
        for k, s in st.opt_state["sparse"].items():
            for n, v in s.items():
                v.copy_(snap["slots"][k][n])
        st.step.copy_(snap["step"])
    st.opt_state["dense"].load_state_dict(copy.deepcopy(snap["adam"]))


def phase_train(seed: int, steps: int, out_dir, profile: bool):
    import torch

    from torecsys_tpu_torch.ops.kernels import sparse_update as K

    batches = make_batches(seed + 1, steps + COMPARE_STEPS)
    torch.cuda.reset_peak_memory_stats()
    trainer = build_trainer(seed)
    table = trainer.pipeline.inputs.schema["emb_inputs"].embedding
    log(f"[train] table {tuple(table.shape)}, m||v {(table.shape[0], 2, table.shape[1])}, "
        f"{sum(FIELD_SIZES)} logical rows")

    warm = min(3, steps - 1)
    K.widen_segment_sum.launches = 0
    K.fused_rowwise_update.launches = 0
    losses = trainer.train_steps(batches[:warm])
    torch.cuda.synchronize()
    trainer.host_ms = dict.fromkeys(trainer.host_ms, 0.0)
    t0 = time.perf_counter()
    losses += trainer.train_steps(batches[warm:steps])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"widen_segment_sum": K.widen_segment_sum.launches,
                "fused_rowwise_update": K.fused_rowwise_update.launches}
    loss_vals = torch.stack(losses).tolist()
    n_timed = steps - warm
    eps = BATCH * n_timed / elapsed
    host = {k: v / n_timed for k, v in trainer.host_ms.items()}
    log(f"[train] {steps} steps, losses first {loss_vals[0]:.6f} last {loss_vals[-1]:.6f}")
    log(f"[train] launches {launches} (steps {steps})")
    log(f"[train] steady-state examples/sec={eps:.1f} step_ms={elapsed / n_timed * 1e3:.3f} "
        f"host ms/step: presort={host['presort']:.3f} place={host['place']:.3f} "
        f"enqueue={host['step']:.3f}; "
        f"peak_memory_gb={torch.cuda.max_memory_allocated() / 1e9:.3f}")
    if not all(np.isfinite(loss_vals)):
        raise AssertionError(f"non-finite training loss: {loss_vals}")
    for name, n in launches.items():
        if n != steps:
            raise AssertionError(f"{name} launched {n} times in {steps} steps")

    prof_info = None
    if profile:
        prof_info = profile_steps(trainer, batches[:3], out_dir)

    # -- kernels vs plain versions, 3 steps each from one copied state --
    cmp_batches = batches[steps:steps + COMPARE_STEPS]
    snap = snapshot(trainer)
    touched = []
    for b in cmp_batches:
        _, aux = presorted_stream(b, 8)
        touched.append(torch.from_numpy(aux["uids"][:int(aux["n_unique"][0])]))
    touched = torch.unique(torch.cat(touched)).to(table.device).long()
    loss_k = torch.stack(trainer.train_steps(cmp_batches)).tolist()
    rows_k = table.detach().index_select(0, touched)
    restore(trainer, snap)
    kernel_fns = (K.widen_segment_sum, K.fused_rowwise_update)
    K.widen_segment_sum, K.fused_rowwise_update = (K.widen_segment_sum_plain,
                                                   K.fused_rowwise_update_plain)
    try:
        loss_p = torch.stack(trainer.train_steps(cmp_batches)).tolist()
    finally:
        K.widen_segment_sum, K.fused_rowwise_update = kernel_fns
    rows_p = table.detach().index_select(0, touched)
    row_err = (rows_k - rows_p).abs().max().item()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(loss_k, loss_p))
    log(f"[train] kernels vs plain over {COMPARE_STEPS} steps: losses {loss_k} vs {loss_p} "
        f"(max rel diff {loss_rel:.3g}, rtol {TRAIN_LOSS_RTOL}); "
        f"{touched.numel()} touched rows max_abs_err={row_err:.3g} (atol {TRAIN_ROWS_ATOL})")
    if not loss_rel <= TRAIN_LOSS_RTOL:
        raise AssertionError("train losses with kernels and plain versions disagree")
    if not row_err <= TRAIN_ROWS_ATOL:
        raise AssertionError("touched table rows with kernels and plain versions disagree")
    return {"launches": launches, "examples_per_sec": eps,
            "step_ms": elapsed / n_timed * 1e3, "host_ms_per_step": host,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "losses": loss_vals, "compare": {"loss_kernels": loss_k, "loss_plain": loss_p,
                                             "row_max_abs_err": row_err},
            "profile": prof_info}


def profile_steps(trainer, batches, out_dir):
    """torch.profiler over a few steady steps: device time by kernel, and the
    device's busy time as the union of its kernel and copy intervals."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_steps(batches)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    n = len(batches)
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.name.startswith(("Optimizer.", "ProfilerStep"))]
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    lines = [f"{us / n:10.1f} us/step  {name[:110]}" for name, us in top]
    log(f"[profile] {n} steps: wall {wall_us / n:.1f} us/step (profiler on), device busy "
        f"{busy_us / n:.1f} us/step ({busy_us / wall_us:.3f} of the window)")
    for line in lines:
        log(f"[profile] {line}")
    if out_dir:
        attr = ("self_device_time_total" if hasattr(prof.key_averages()[0], "self_device_time_total")
                else "self_cuda_time_total")
        with open(os.path.join(out_dir, "chip_smoke_profile.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by=attr, row_limit=60))
    return {"wall_us_per_step": wall_us / n, "device_busy_us_per_step": busy_us / n,
            "top": lines}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=None, help="directory for the full JSON record")
    ap.add_argument("--profile", action="store_true",
                    help="trace 3 training steps with torch.profiler")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on the card",
              file=sys.stderr)
        return 1
    import torecsys_tpu_torch  # noqa: F401  (fails outside the repository)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[setup] torch", torch.__version__, "cuda", torch.version.cuda,
        "| float32 matmul and cuDNN TF32 off (allow_tf32 = False)")
    card = card_line()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    t_start = time.perf_counter()

    phase_build()
    batch = make_batches(args.seed, 1)[0]
    records = phase_kernels(batch, args.seed)
    train = phase_train(args.seed, args.steps, args.out, args.profile)
    kernels = []
    for name, rec in records.items():
        kernels.append({**rec, "launches": train["launches"][name]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump({"card": card, "kernels": kernels, "train": train}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
