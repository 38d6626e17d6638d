#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``torecsys_tpu_torch``).

Run from the root of the repository on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed 0] [--steps 20] [--out DIR] [--profile]

Phases (any failure raises and the exit code is not 0):

1. Build the port's CUDA kernels from ``torecsys_tpu_torch/csrc`` with nvcc,
   one compiler per source, all started together.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes of the main path: one Criteo-scale batch (the workload of
   ``bench.py``: 28 Zipf(1.2) id fields over 32.9M fused rows, batch 4096,
   E=16) presorted by the port's ``Presorter``.  Prints each kernel's time,
   its plain version's time, the time of one PyTorch call computing the
   same function where there is one, and its bound.
3. Train the full-width DeepFM (tower 400-400-400, Adam 1e-3, sparse
   presorted embedding route) through the port's ``Trainer`` for ``--steps``
   steps; every kernel of the route must launch once per step.  Then take
   3 more steps twice from one copied state, with the kernels and with their
   plain versions, and compare.
4. Evaluate the trained model on 8 held-out batches (``Trainer.evaluate``:
   one ``row_gather`` per batch) and predict one batch with the kernel and
   with its plain version: the scores must be bit-identical.
5. Train the same model on the dense-table route (Adam over every
   parameter, the table included) for ``--steps`` steps, then compare 3
   steps with the kernel and with its plain version from one copied state.
6. Train the ``pack == 1`` sparse route: the same DeepFM with E=128 on the
   bench id streams, each field capped at 1,000,000 rows, for 5 steps.

Every path is driven with all launch counts set to 0 just before it and
read just after.  The second-to-last lines are a JSON object of the kernels
exercised and the card's name and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
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
# Phase 6: E=128 packs one logical row per stored row.  28 fields of 32.9M
# rows at E=128 would need 50 GB before the copied state, so each field is
# capped at 1M rows (12,884,400 rows); the cap is the only cut.
EMBED_WIDE = 128
ROWS_CAP = 1_000_000
PACK1_STEPS = 5
EVAL_BATCHES = 8

# H100 SXM published peaks (NVIDIA data sheet): HBM rate and float32 rate
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

SEGSUM_ATOL = 1e-5   # g is drawn on a 2^-10 grid: every partial sum is exact
UPDATE_ATOL = 1e-6
TRAIN_LOSS_RTOL = 1e-5
TRAIN_ROWS_ATOL = 1e-6
# Dense route, kernel vs plain gather over 3 steps: the forward gathers are
# bit-identical, but the backward's index_add_ sums duplicate ids with
# atomics in an order that changes from run to run, so the table gradient
# differs in its last bits where an id occurs 3 or more times.  Adam turns a
# gradient difference dg into a step difference of at most
# lr * (1 - b1) / (1 - b1^t) * dg / eps, about 1e-8 for the rounding of
# sums of 1e-5-sized cotangents; 1e-6 (1e-3 of lr) leaves a wide margin.
DENSE_LOSS_RTOL = 1e-5
DENSE_TABLE_ATOL = 1e-6
COMPARE_STEPS = 3
DEVICE = "cuda"
SOURCES = ("sparse_update.cu", "embedding.cu")


def make_batches(seed: int, n_batches: int, field_sizes=None):
    """Host batches exactly as ``bench.py:59-71`` makes them (ids capped at
    each field's size; ``field_sizes`` defaults to the bench's)."""
    field_sizes = FIELD_SIZES if field_sizes is None else field_sizes
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(n_batches):
        b = {}
        for i, v in enumerate(field_sizes):
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


# ---- the kernels and their counters ----------------------------------------

KERNEL_NAMES = ("widen_segment_sum", "fused_rowwise_update", "row_gather", "segment_sum_wide")


def _kernel_module(name: str):
    from torecsys_tpu_torch.ops.kernels import embedding as KE
    from torecsys_tpu_torch.ops.kernels import sparse_update as K

    return KE if name == "row_gather" else K


def kernels():
    """The kernel wrappers as the port's modules hold them now."""
    return {name: getattr(_kernel_module(name), name) for name in KERNEL_NAMES}


def reset_counts(fns) -> None:
    for fn in fns.values():
        fn.launches = 0


def read_counts(fns):
    return {name: fn.launches for name, fn in fns.items()}


@contextlib.contextmanager
def plain_versions(fns):
    """Put every kernel's plain version in its wrapper's place."""
    for name in fns:
        mod = _kernel_module(name)
        setattr(mod, name, getattr(mod, f"{name}_plain"))
    try:
        yield
    finally:
        for name, fn in fns.items():
            setattr(_kernel_module(name), name, fn)


def check_counts(path: str, counts, want) -> None:
    log(f"[{path}] launches {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"{path}: kernel launches {counts}, expected {want}")


# ---- phase 1 ---------------------------------------------------------------

def phase_build():
    from torecsys_tpu_torch.ops import kernels as build

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        futures = {src: pool.submit(build.build, src) for src in SOURCES}
        results = {src: f.result() for src, f in futures.items()}
    log(f"[build] {len(SOURCES)} sources in parallel in {time.perf_counter() - t0:.2f} s")
    for src, (path, report) in results.items():
        log(f"[build] {src} -> {path.name}")
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


def grid_randn(shape, gen, dev):
    """Random values on a 2^-10 grid: every partial sum of a segment is exact
    in float32, so a kernel and its plain version must agree to the bit
    whatever order they sum in."""
    import torch

    return torch.randn(*shape, device=dev, generator=gen).mul_(1024).round_().div_(1024)


def phase_kernels(batch, seed: int):
    import torch

    from torecsys_tpu_torch.ops.embedding import field_offsets, packed_shape
    from torecsys_tpu_torch.ops.kernels import embedding as KE
    from torecsys_tpu_torch.ops.kernels import sparse_update as K

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    m = BATCH * len(FIELD_SIZES)
    g = grid_randn((m, EMBED), gen, dev)
    records = {}

    # -- widened segment-sum, pack 8 (main path) and pack 1 --
    seg_err = 0.0
    n_unique_of = {}
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
        n_unique = n_unique_of[pack] = int(aux["n_unique"][0])
        longest = int(np.bincount(aux["seg"]).max())
        log(f"[segsum] pack={pack} M={m} n_unique={n_unique} longest segment={longest} "
            f"max_abs_err={err:.3g} (atol {SEGSUM_ATOL})")
        if not err <= SEGSUM_ATOL:
            raise AssertionError(f"widen_segment_sum pack={pack} disagrees: {err}")
        seg_err = max(seg_err, err)
        if pack == 1:
            records["segment_sum_wide"] = check_segment_sum_wide(seg, n_unique, longest,
                                                                 gen, dev)
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
        del wide, seg64
    records["widen_segment_sum"]["max_abs_err"] = seg_err
    log_unported_bounds(m, n_unique_of[8], n_unique_of[1])

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
    del touched, gsum

    # -- row gather: the bench batch's shifted ids into the logical view (the
    # main path's lookup), and their stored rows into the stored table --
    ids = np.stack([batch[f"cat_{i}"] for i in range(len(FIELD_SIZES))], axis=1)
    shifted = torch.from_numpy((ids.astype(np.int64) + field_offsets(FIELD_SIZES)).reshape(-1))
    shifted = shifted.to(dev)
    cases = [("logical view", table0.view(-1, EMBED), shifted),
             ("stored rows", table0, shifted // (w // EMBED))]
    gather_err = 0.0
    for label, src, idx in cases:
        got = KE.row_gather(src, idx)
        ref = KE.row_gather_plain(src, idx)
        torch.cuda.synchronize()
        same = torch.equal(got, ref)
        err = (got - ref).abs().max().item()
        gather_err = max(gather_err, err)
        if not same:
            raise AssertionError(f"row_gather on the {label} is not bit-identical: {err}")
        num, width = idx.shape[0], src.shape[1]
        kernel_ms = time_ms(lambda: KE.row_gather(src, idx), 200)
        plain_ms = time_ms(lambda: KE.row_gather_plain(src, idx), 100)
        library_ms = time_ms(lambda: src.index_select(0, idx), 200)
        # each id read once, each distinct row read once, each output row
        # written once
        distinct = torch.unique(idx).numel()
        bound_ms, bound_by = bound(
            num * idx.element_size() + distinct * width * 4 + num * width * 4, 0)
        log(f"[gather] {label} {tuple(src.shape)} num={num} distinct={distinct} "
            f"width={width}: bit-identical "
            f"to the plain version; kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} (index_select on the same view, the port's "
            f"lookup before) bound_us={bound_ms * 1e3:.2f} ({bound_by})")
        if label == "logical view":
            records["row_gather"] = dict(
                name="row_gather", route="cuda", source="torecsys_tpu_torch/csrc/embedding.cu",
                replaces="torecsys_tpu/ops/pallas/embedding.py:40",
                ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)
    records["row_gather"]["max_abs_err"] = gather_err
    del table0, shifted
    torch.cuda.empty_cache()
    return records


def log_unported_bounds(m: int, n_stored: int, n_logical: int) -> None:
    """Bounds of the two TPU kernels not yet ported, at this batch's shapes:
    ``n_stored`` unique stored rows (P = 8), ``n_logical`` unique ids."""
    w = 8 * EMBED
    # unique_stored_gather: read the valid uids and each distinct stored row
    # once, write one stored row per valid uid.
    gather_ms, gather_by = bound(n_logical * 4 + n_stored * w * 4 + n_logical * w * 4, 0)
    # fused_sorted_dedup_update (adam): read the sorted ids and narrow grads,
    # read and write each touched stored row and its m||v; ~14 float
    # operations per updated element.
    dedup_ms, dedup_by = bound(m * 4 + m * EMBED * 4 + n_stored * 2 * (w * 4 + 2 * w * 4),
                               n_stored * w * 14)
    log(f"[bound] unique_stored_gather (not ported): {n_logical} unique ids, {n_stored} "
        f"stored rows of {w}: bound_us={gather_ms * 1e3:.3f} ({gather_by})")
    log(f"[bound] fused_sorted_dedup_update (not ported): M={m}, E={EMBED}, {n_stored} "
        f"touched stored rows: bound_us={dedup_ms * 1e3:.3f} ({dedup_by})")


def check_segment_sum_wide(seg, n_unique: int, longest: int, gen, dev):
    """segment_sum_wide on the bench batch's pack-1 presorted segments with a
    W = 128 stream (the E = 128 route's width)."""
    import torch

    from torecsys_tpu_torch.ops.kernels import sparse_update as K

    m, w = seg.shape[0], EMBED_WIDE
    wide = grid_randn((m, w), gen, dev)
    got = K.segment_sum_wide(wide, seg)
    ref = K.segment_sum_wide_plain(wide, seg)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    if not torch.equal(got, ref):
        raise AssertionError(f"segment_sum_wide is not bit-identical: {err}")
    seg64 = seg.long()
    kernel_ms = time_ms(lambda: K.segment_sum_wide(wide, seg), 50)
    plain_ms = time_ms(lambda: K.segment_sum_wide_plain(wide, seg), 20)
    library_ms = time_ms(lambda: torch.zeros(m, w, device=dev).index_add_(0, seg64, wide), 50)
    bound_ms, bound_by = bound(m * w * 4 + m * 4 + m * w * 4, m * w)
    log(f"[segsum-wide] M={m} W={w} n_unique={n_unique} longest segment={longest}: "
        f"bit-identical to the plain version; kernel_ms={kernel_ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"(torch.zeros(M,W).index_add_) bound_us={bound_ms * 1e3:.2f} ({bound_by})")
    return dict(name="segment_sum_wide", route="cuda",
                source="torecsys_tpu_torch/csrc/sparse_update.cu",
                replaces="torecsys_tpu/ops/pallas/sparse_update.py:389",
                max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


# ---- phases 3-6: the trainer's paths ----------------------------------------

def build_trainer(seed: int, sparse: bool = True, embed: int = EMBED, field_sizes=None):
    from torecsys_tpu_torch import Inputs, MultiIndicesEmbedding, Pipeline, Trainer, ValueInput

    field_sizes = FIELD_SIZES if field_sizes is None else field_sizes
    inputs = Inputs({
        "feat_inputs": ValueInput(tuple(f"dense_{j}" for j in range(NUM_DENSE))),
        "emb_inputs": MultiIndicesEmbedding(
            embed, field_sizes, tuple(f"cat_{i}" for i in range(len(field_sizes))),
            device=DEVICE),
    })
    pipeline = (
        Pipeline(device=DEVICE).set_objective("ctr").set_inputs(inputs)
        .set_model("DeepFM", deep_layer_sizes=TOWER)
        .set_criterion("BCEWithLogitsLoss").set_optimizer("Adam", lr=1e-3)
        .set_sparse_embeddings(sparse).set_target_fields("label")
    )
    trainer = Trainer(pipeline, log_every=10**9, seed=seed)
    trainer.init_state()
    return trainer


def release() -> None:
    """Hand the memory of a trainer the caller has deleted back to the card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _optimizers(trainer):
    """(dense torch optimizer, row-wise slots or {}) of either route."""
    opt = trainer.state.opt_state
    return (opt["dense"], opt["sparse"]) if isinstance(opt, dict) else (opt, {})


def snapshot(trainer):
    seq = trainer.pipeline.sequential
    dense_opt, slots = _optimizers(trainer)
    return {
        "params": {n: p.detach().clone() for n, p in seq.named_parameters()},
        "adam": copy.deepcopy(dense_opt.state_dict()),
        "slots": {k: {n: v.clone() for n, v in s.items()} for k, s in slots.items()},
        "step": trainer.state.step.clone(),
    }


def restore(trainer, snap):
    import torch

    seq = trainer.pipeline.sequential
    dense_opt, slots = _optimizers(trainer)
    with torch.no_grad():
        for n, p in seq.named_parameters():
            p.copy_(snap["params"][n])
        for k, s in slots.items():
            for n, v in s.items():
                v.copy_(snap["slots"][k][n])
        trainer.state.step.copy_(snap["step"])
    dense_opt.load_state_dict(copy.deepcopy(snap["adam"]))


def timed_steps(trainer, batches, fns, path: str):
    """Counts to 0, 3 warm-up steps, the rest timed, counts read: returns
    (launch counts, per-step losses, examples/sec, host ms per step)."""
    import torch

    warm = min(3, len(batches) - 1)
    reset_counts(fns)
    losses = trainer.train_steps(batches[:warm])
    torch.cuda.synchronize()
    trainer.host_ms = dict.fromkeys(trainer.host_ms, 0.0)
    t0 = time.perf_counter()
    losses += trainer.train_steps(batches[warm:])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = read_counts(fns)
    loss_vals = torch.stack(losses).tolist()
    n_timed = len(batches) - warm
    host = {k: v / n_timed for k, v in trainer.host_ms.items()}
    eps = BATCH * n_timed / elapsed
    log(f"[{path}] {len(batches)} steps, losses first {loss_vals[0]:.6f} "
        f"last {loss_vals[-1]:.6f}")
    log(f"[{path}] steady-state examples/sec={eps:.1f} step_ms={elapsed / n_timed * 1e3:.3f} "
        f"host ms/step: presort={host['presort']:.3f} place={host['place']:.3f} "
        f"enqueue={host['step']:.3f}; peak_memory_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    if not all(np.isfinite(loss_vals)):
        raise AssertionError(f"{path}: non-finite training loss: {loss_vals}")
    return counts, loss_vals, eps, host


def compare_with_plain(trainer, batches, fns, path: str, rows_of, loss_rtol, rows_atol):
    """Take ``batches`` from one copied state with the kernels and with their
    plain versions; compare the losses and the table rows ``rows_of``."""
    import torch

    table = trainer.pipeline.inputs.schema["emb_inputs"].embedding
    snap = snapshot(trainer)
    loss_k = torch.stack(trainer.train_steps(batches)).tolist()
    rows_k = rows_of(table.detach())
    restore(trainer, snap)
    del snap
    with plain_versions(fns):
        loss_p = torch.stack(trainer.train_steps(batches)).tolist()
    rows_p = rows_of(table.detach())
    row_err = (rows_k - rows_p).abs().max().item()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(loss_k, loss_p))
    log(f"[{path}] kernels vs plain over {len(batches)} steps: losses {loss_k} vs {loss_p} "
        f"(max rel diff {loss_rel:.3g}, rtol {loss_rtol}); {rows_k.shape[0]} table rows "
        f"max_abs_err={row_err:.3g} (atol {rows_atol})")
    if not loss_rel <= loss_rtol:
        raise AssertionError(f"{path}: losses with kernels and plain versions disagree")
    if not row_err <= rows_atol:
        raise AssertionError(f"{path}: table rows with kernels and plain versions disagree")
    return {"loss_kernels": loss_k, "loss_plain": loss_p, "row_max_abs_err": row_err}


def phase_train(seed: int, steps: int, out_dir, profile: bool):
    """Phase 3: the sparse main path.  Returns (trainer, record)."""
    import torch

    fns = kernels()
    batches = make_batches(seed + 1, steps + COMPARE_STEPS)
    torch.cuda.reset_peak_memory_stats()
    trainer = build_trainer(seed)
    table = trainer.pipeline.inputs.schema["emb_inputs"].embedding
    log(f"[train] table {tuple(table.shape)}, m||v {(table.shape[0], 2, table.shape[1])}, "
        f"{sum(FIELD_SIZES)} logical rows")
    counts, loss_vals, eps, host = timed_steps(trainer, batches[:steps], fns, "train")
    check_counts("train", counts, {"widen_segment_sum": steps, "fused_rowwise_update": steps,
                                   "row_gather": steps, "segment_sum_wide": 0})
    peak = torch.cuda.max_memory_allocated() / 1e9

    prof_info = None
    if profile:
        prof_info = profile_steps(trainer, batches[:3], out_dir, "train")

    cmp_batches = batches[steps:steps + COMPARE_STEPS]
    touched = []
    for b in cmp_batches:
        _, aux = presorted_stream(b, 8)
        touched.append(torch.from_numpy(aux["uids"][:int(aux["n_unique"][0])]))
    touched = torch.unique(torch.cat(touched)).to(table.device).long()
    compare = compare_with_plain(trainer, cmp_batches, fns, "train",
                                 lambda t: t.index_select(0, touched),
                                 TRAIN_LOSS_RTOL, TRAIN_ROWS_ATOL)
    return trainer, {"launches": counts, "examples_per_sec": eps,
                     "step_ms": BATCH / eps * 1e3, "host_ms_per_step": host,
                     "peak_memory_gb": peak, "losses": loss_vals, "compare": compare,
                     "profile": prof_info}


def phase_eval(trainer, seed: int):
    """Phase 4: evaluate and predict on the trained main-path model."""
    import torch

    fns = kernels()
    val = make_batches(seed + 2, EVAL_BATCHES)
    reset_counts(fns)
    t0 = time.perf_counter()
    metrics = trainer.evaluate(val)  # reads the metrics: waits for the device
    first_s = time.perf_counter() - t0
    counts = read_counts(fns)
    check_counts("eval", counts, {"widen_segment_sum": 0, "fused_rowwise_update": 0,
                                  "row_gather": EVAL_BATCHES, "segment_sum_wide": 0})
    t0 = time.perf_counter()
    again = trainer.evaluate(val)
    second_s = time.perf_counter() - t0
    eps = BATCH * EVAL_BATCHES / second_s
    log(f"[eval] {EVAL_BATCHES} held-out batches: val_auc={metrics['val_auc']:.6f} "
        f"val_logloss={metrics['val_logloss']:.6f} (random labels: val_auc near 0.5 is "
        f"right); examples/sec={eps:.1f} (second pass; first pass "
        f"{BATCH * EVAL_BATCHES / first_s:.1f})")
    if not (np.isfinite(metrics["val_auc"]) and np.isfinite(metrics["val_logloss"])):
        raise AssertionError(f"eval: non-finite metrics {metrics}")
    if again != metrics:
        raise AssertionError(f"eval: a second pass gave {again}, the first {metrics}")

    scores_k = trainer.predict(val[0])
    with plain_versions(fns):
        scores_p = trainer.predict(val[0])
    torch.cuda.synchronize()
    if scores_k.shape != (BATCH, 1) or not torch.isfinite(scores_k).all():
        raise AssertionError(f"predict: bad scores {tuple(scores_k.shape)}")
    if not torch.equal(scores_k, scores_p):
        raise AssertionError("predict: scores with the kernel and the plain gather differ")
    log(f"[predict] {BATCH} scores in (0, 1), mean {scores_k.mean().item():.6f}; "
        f"bit-identical with the plain gather")
    return {"launches": counts, "metrics": metrics, "examples_per_sec": eps,
            "first_pass_examples_per_sec": BATCH * EVAL_BATCHES / first_s}


def phase_dense(seed: int, steps: int, sparse_eps: float, out_dir, profile: bool):
    """Phase 5: the dense-table route at full width."""
    import torch

    fns = kernels()
    batches = make_batches(seed + 1, steps + COMPARE_STEPS)
    torch.cuda.reset_peak_memory_stats()
    trainer = build_trainer(seed, sparse=False)
    counts, loss_vals, eps, host = timed_steps(trainer, batches[:steps], fns, "dense")
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_counts("dense", counts, {"widen_segment_sum": 0, "fused_rowwise_update": 0,
                                   "row_gather": steps, "segment_sum_wide": 0})
    log(f"[dense] examples/sec dense route {eps:.1f} vs sparse route {sparse_eps:.1f} "
        f"(phase 3), the same model and batches; peak_memory_gb={peak:.3f}")
    prof_info = profile_steps(trainer, batches[:3], out_dir, "dense") if profile else None
    compare = compare_with_plain(trainer, batches[steps:], fns, "dense", lambda t: t.clone(),
                                 DENSE_LOSS_RTOL, DENSE_TABLE_ATOL)
    del trainer
    release()
    return {"launches": counts, "examples_per_sec": eps, "host_ms_per_step": host,
            "peak_memory_gb": peak, "losses": loss_vals, "compare": compare,
            "profile": prof_info}


def phase_pack1(seed: int):
    """Phase 6: the pack == 1 sparse route (E = 128, fields capped)."""
    import torch

    fns = kernels()
    field_sizes = tuple(min(v, ROWS_CAP) for v in FIELD_SIZES)
    batches = make_batches(seed + 3, PACK1_STEPS, field_sizes)
    torch.cuda.reset_peak_memory_stats()
    trainer = build_trainer(seed, embed=EMBED_WIDE, field_sizes=field_sizes)
    table = trainer.pipeline.inputs.schema["emb_inputs"].embedding
    log(f"[pack1] table {tuple(table.shape)} ({table.numel() * 4 / 1e9:.2f} GB), "
        f"{sum(field_sizes)} rows, pack {trainer.pipeline.inputs.schema['emb_inputs'].pack}")
    counts, loss_vals, eps, host = timed_steps(trainer, batches, fns, "pack1")
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_counts("pack1", counts, {"widen_segment_sum": 0, "fused_rowwise_update": PACK1_STEPS,
                                   "row_gather": PACK1_STEPS,
                                   "segment_sum_wide": PACK1_STEPS})
    del trainer, table
    release()
    return {"launches": counts, "examples_per_sec": eps, "host_ms_per_step": host,
            "peak_memory_gb": peak, "losses": loss_vals}


def profile_steps(trainer, batches, out_dir, path: str):
    """torch.profiler over a few steady steps of ``path``: device time by
    kernel, and the device's busy time as the union of its kernel and copy
    intervals."""
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
    log(f"[profile] {path}, {n} steps: wall {wall_us / n:.1f} us/step (profiler on), "
        f"device busy {busy_us / n:.1f} us/step ({busy_us / wall_us:.3f} of the window)")
    for line in lines:
        log(f"[profile] {path} {line}")
    if out_dir:
        attr = ("self_device_time_total"
                if hasattr(prof.key_averages()[0], "self_device_time_total")
                else "self_cuda_time_total")
        with open(os.path.join(out_dir, f"chip_smoke_profile_{path}.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by=attr, row_limit=60))
    return {"wall_us_per_step": wall_us / n, "device_busy_us_per_step": busy_us / n,
            "top": lines}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=None, help="directory for the full JSON record")
    ap.add_argument("--profile", action="store_true",
                    help="trace 3 sparse and 3 dense training steps with torch.profiler")
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
    log(f"[setup] card {card}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    t_start = time.perf_counter()
    phase_s = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t0
        log(f"[time] {name} {phase_s[name]:.1f} s")
        return out

    timed("build", phase_build)
    batch = make_batches(args.seed, 1)[0]
    records = timed("kernels", phase_kernels, batch, args.seed)
    trainer, train = timed("train", phase_train, args.seed, args.steps, args.out, args.profile)
    evaluation = timed("eval", phase_eval, trainer, args.seed)
    del trainer
    release()
    dense = timed("dense", phase_dense, args.seed, args.steps, train["examples_per_sec"],
                  args.out, args.profile)
    pack1 = timed("pack1", phase_pack1, args.seed)
    paths = {"train": train, "eval": evaluation, "dense": dense, "pack1": pack1}
    # Each kernel's launches are those of the path that carries it: the
    # sparse main path (phase 3), or the pack == 1 route for segment_sum_wide.
    home = {"widen_segment_sum": "train", "fused_rowwise_update": "train",
            "row_gather": "train", "segment_sum_wide": "pack1"}
    kernel_lines = []
    for name in KERNEL_NAMES:
        by_path = {p: rec["launches"][name] for p, rec in paths.items()}
        kernel_lines.append({**records[name], "launches": by_path[home[name]],
                             "launches_by_path": by_path})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump({"card": card, "kernels": kernel_lines, "phase_s": phase_s, **paths}, f,
                      indent=1)
    print(json.dumps({"kernels": kernel_lines}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
