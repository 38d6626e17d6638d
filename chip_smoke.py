#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``torecsys_tpu_torch``).

Run from the root of the repository on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed 0] [--steps 20] [--out DIR] [--profile]

Phases (any failure raises and the exit code is not 0):

1. Build the port's CUDA kernels from ``torecsys_tpu_torch/csrc`` with nvcc,
   one compiler per source, all started together, and beside them the row
   gather's sweep build (``embedding.cu`` with ``TRS_ROW_GATHER_SWEEP``).
2. Hold each of the six kernels against its plain PyTorch version on the
   card, at the shapes of the main path: one Criteo-scale batch (the
   workload of ``bench.py``: 28 Zipf(1.2) id fields over 32.9M fused rows,
   batch 4096, E=16), presorted by the port's ``Presorter`` or sorted on
   the card.  Prints each kernel's time, its plain version's time, the time
   of one PyTorch call computing the same function where there is one, and
   its bound; each time is the device's own (the kernels' durations in a
   torch.profiler window), with CUDA events around the same calls beside it,
   and again with the L2 cache flushed before each call (``cold_ms``).
   Then sweeps both segment sums over skewed and tile-edge streams (the
   bench stream, one segment, M distinct segments, segments on tile edges,
   M = 1): grid grads bit-identical to the plain version, real-valued grads
   within the float64 rounding bound, two launches bit-identical; sweeps
   ``fused_sorted_dedup_update`` over the same streams as stored rows and a
   sentinel tail, at P = 8 and P = 1, each rule on real-valued grads: table
   and slots bit-identical to the default combine's, two launches
   bit-identical, untouched rows unchanged; sweeps ``unique_stored_gather``
   over valid prefixes of several lengths, each bit-identical to
   ``index_select``; holds ``row_gather`` to its plain version bit for bit
   on the lookup, the stored rows and the grad permute (int32 and int64
   order), times the sweep build's chunks (8, 16, 32 ids a warp) and reads
   in flight (2, 4, 8 a lane) on the lookup, and sweeps it over edge streams
   (M distinct ids, one id, chunk edges, NaN rows, width 13, an offset
   pointer); and holds the lookup's backward (``table_grad``) to the
   ``index_add_`` form it replaced, timing both.
3. Train the full-width DeepFM (tower 400-400-400, Adam 1e-3, sparse
   presorted embedding route) through the port's ``Trainer`` for ``--steps``
   steps; every kernel of the route must launch once per step, the row
   gather twice (the lookup and the grad permute).  Then take 3 more steps,
   each from the kernels' state both with the kernels and with their plain
   versions, and compare.
4. Evaluate the trained model on 8 held-out batches (``Trainer.evaluate``:
   one ``row_gather`` per batch) and predict one batch with the kernel and
   with its plain version: the scores must be bit-identical.
5. Train the same model on the on-device sparse route
   (``Trainer(presort=False)``) on phase 3's batches, ``--steps`` steps on
   the default combine and ``--steps`` with ``TORECSYS_TPU_FUSED_DEDUP=1``;
   then 3 steps, each from the default combine's state, of each variant
   with the kernels and with their plain versions and of the presorted
   route, all compared (the fused kernel's losses, table and slots to the
   bit).
6. Train the same model on the dense-table route (Adam over every
   parameter, the table included) for ``--steps`` steps; take 3 steps twice
   with the kernels from one state (losses, table and Adam moments must be
   the same bits), then compare 3 steps with the kernels and with their
   plain versions, as in phase 3.
7. Train the ``pack == 1`` sparse route: the same DeepFM with E=128 on the
   bench id streams, each field capped at 1,000,000 rows, for 5 steps.

Every path is driven with all launch counts set to 0 just before it and
read just after.  ``--profile`` traces 3 steps of each training route and
prints each kernel's device time in the step.  The second-to-last lines are
a JSON object of the kernels exercised and the card's name and power limit;
the last line is
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
# Phase 7: E=128 packs one logical row per stored row.  28 fields of 32.9M
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
# Dense route, kernels vs plain versions over 3 steps: the forward gathers
# are bit-identical, and the kernels' backward gives the same bits from run
# to run (phase 6 holds two runs to the bit), but the plain twin of its
# per-row sum is index_add_, which on the card sums duplicate ids with
# atomics in an order that changes from run to run, so the two table
# gradients differ in their last bits where an id occurs 3 or more times.
# Adam turns a gradient difference dg into a step difference of at most
# lr * (1 - b1) / (1 - b1^t) * dg / eps, about 1e-8 for the rounding of
# sums of 1e-5-sized cotangents; 1e-6 (1e-3 of lr) leaves a wide margin.
DENSE_LOSS_RTOL = 1e-5
DENSE_TABLE_ATOL = 1e-6
COMPARE_STEPS = 3
DEVICE = "cuda"
# (source, macros): the port's two libraries, and the row gather's sweep
# build (other chunks and reads in flight, for phase 2's [gather-config])
SWEEP_BUILD = ("embedding.cu", ("TRS_ROW_GATHER_SWEEP",))
BUILDS = (("sparse_update.cu", ()), ("embedding.cu", ()), SWEEP_BUILD)


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


def device_events(prof):
    """The kernels and copies the card ran in a torch.profiler window."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(("Optimizer.", "ProfilerStep"))]


def device_ms(fn, iters: int, before=None) -> float:
    """Device ms per call of ``fn`` over ``iters`` calls: the sum of the
    durations of the kernels and copies the calls ran, from a torch.profiler
    window, the card's own time.  ``before``, where given, runs before each
    call, and its kernels are left out by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    skip = set()
    for _ in range(3 if before is not None else 0):  # as below: retried
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            before()
            torch.cuda.synchronize()
        skip = {e.name for e in device_events(prof)}
        if skip:
            break
    if before is not None and not skip:
        raise AssertionError("torch.profiler recorded no kernel of the call before")
    for _ in range(3):  # a window now and then comes back without its kernels
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
        events = [e for e in device_events(prof) if e.name not in skip]
        if len(events) >= iters:  # every call launches at least one kernel
            busy_us = sum(e.time_range.end - e.time_range.start for e in events)
            return busy_us / 1e3 / iters
    raise AssertionError(f"torch.profiler recorded {len(events)} kernels for {iters} calls")


def time_ms(fn, iters: int):
    """(device ms, event ms) per call of ``fn``, each over ``iters`` calls
    after 3 warm-up calls (:func:`device_ms`).  Event ms is CUDA events
    around back-to-back calls: for a kernel shorter than the host's work per
    call it measures the host's call rate instead."""
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
    return device_ms(fn, iters), start.elapsed_time(end) / iters


L2_FLUSH_BYTES = 256 << 20  # over five times the H100's 50 MB L2


def cold_time_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn`` with the L2 cache flushed before each
    call (a 256 MB buffer written between calls), after 3 warm-up calls."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=DEVICE)
    for _ in range(3):
        flush.fill_(1.0)
        fn()
    return device_ms(fn, iters, before=lambda: flush.fill_(1.0))


def times_text(label: str, t) -> str:
    return f"{label}={t[0]:.4f} (events {t[1]:.4f})"


def time_keys(prefix: str, t):
    """A record's keys for a (device ms, event ms) pair."""
    return {prefix: t[0], f"{prefix}_events": t[1]}


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

KERNEL_NAMES = ("widen_segment_sum", "fused_rowwise_update", "row_gather", "segment_sum_wide",
                "unique_stored_gather", "fused_sorted_dedup_update")


def _kernel_module(name: str):
    from torecsys_tpu_torch.ops.kernels import embedding as KE
    from torecsys_tpu_torch.ops.kernels import sparse_update as K

    return KE if name in ("row_gather", "unique_stored_gather") else K


def expect(**counts):
    """Expected launches of every kernel: those named, 0 for the others."""
    return {name: counts.get(name, 0) for name in KERNEL_NAMES}


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


@contextlib.contextmanager
def fused_dedup(flag: str):
    """Set ``TORECSYS_TPU_FUSED_DEDUP`` in this process for the block."""
    from torecsys_tpu_torch.ops.sparse import FUSED_DEDUP_ENV

    before = os.environ.get(FUSED_DEDUP_ENV)
    os.environ[FUSED_DEDUP_ENV] = flag
    try:
        yield
    finally:
        if before is None:
            os.environ.pop(FUSED_DEDUP_ENV)
        else:
            os.environ[FUSED_DEDUP_ENV] = before


def check_counts(path: str, counts, want) -> None:
    log(f"[{path}] launches {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"{path}: kernel launches {counts}, expected {want}")


# ---- phase 1 ---------------------------------------------------------------

def phase_build():
    from torecsys_tpu_torch.ops import kernels as build

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(BUILDS)) as pool:
        futures = {b: pool.submit(build.build, *b) for b in BUILDS}
        results = {b: f.result() for b, f in futures.items()}
    log(f"[build] {len(BUILDS)} builds in parallel in {time.perf_counter() - t0:.2f} s")
    for (src, defines), (path, report) in results.items():
        log(f"[build] {src} {' '.join('-D' + d for d in defines)} -> {path.name}")
        kernel = ""
        for line in report.splitlines():
            if "Function properties for" in line:
                kernel = demangle(line.split("Function properties for")[-1].strip())
            elif "registers" in line or "spill" in line:
                log(f"[build] {kernel}: {line.strip()}")


def demangle(name: str) -> str:
    """A kernel's C++ name without its parameters (``c++filt``), its mangled
    name where that tool is missing."""
    try:
        out = subprocess.run(["c++filt", name], capture_output=True, text=True, timeout=10)
    except OSError:
        return name
    return out.stdout.replace("(anonymous namespace)::", "").split("(")[0].strip() or name


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
    bench_streams = {}
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
        bench_streams[pack] = (lo, seg)
        if pack == 1:
            records["segment_sum_wide"] = check_segment_sum_wide(seg, n_unique, longest,
                                                                 gen, dev)
            continue
        w = pack * EMBED
        kernel_t = time_ms(lambda: K.widen_segment_sum(g_sorted, lo, seg, pack), 50)
        cold = cold_time_ms(lambda: K.widen_segment_sum(g_sorted, lo, seg, pack), COLD_ITERS)
        plain_t = time_ms(lambda: K.widen_segment_sum_plain(g_sorted, lo, seg, pack), 20)
        wide = torch.zeros(m, pack, EMBED, device=dev)
        wide[torch.arange(m, device=dev), lo.long()] = g_sorted
        wide = wide.reshape(m, w)
        seg64 = seg.long()
        library_t = time_ms(
            lambda: torch.zeros(m, w, device=dev).index_add_(0, seg64, wide), 50)
        bound_ms, bound_by = bound(m * EMBED * 4 + 2 * m * 4 + m * w * 4, m * EMBED)
        log(f"[segsum] {times_text('kernel_ms', kernel_t)} cold_ms={cold:.4f} "
            f"{times_text('plain_ms', plain_t)} "
            f"{times_text('library_ms', library_t)} (torch.zeros(M,W).index_add_ on a "
            f"pre-widened stream, a near-yardstick) bound_us={bound_ms * 1e3:.2f} "
            f"({bound_by}) n_unique={n_unique}")
        records["widen_segment_sum"] = dict(
            name="widen_segment_sum", route="cuda",
            source="torecsys_tpu_torch/csrc/sparse_update.cu",
            replaces="torecsys_tpu/ops/pallas/sparse_update.py:248",
            max_abs_err=seg_err, **time_keys("ms", kernel_t), cold_ms=cold,
            **time_keys("plain_ms", plain_t), bound_ms=bound_ms, bound_by=bound_by,
            **time_keys("library_ms", library_t))
        gsum, uids = got, torch.from_numpy(aux["uids"]).to(dev)
        n_valid = n_unique
        del wide, seg64
    records["widen_segment_sum"]["max_abs_err"] = seg_err
    sweep = sweep_segment_sums(bench_streams, gen, dev)
    for name, by_stream in sweep.items():
        records[name]["sweep"] = by_stream

    # -- fused row-wise update, each rule, on a full-size table --
    rows, w = packed_shape(sum(FIELD_SIZES), EMBED)
    table0 = torch.empty(rows, w, device=dev).normal_(0.0, 0.01, generator=gen)
    touched = torch.zeros(rows, dtype=torch.bool, device=dev)
    touched[uids[:n_valid].long()] = True
    cases = [("adam", 0.0), ("adam", 1e-2), ("adagrad", 0.0), ("sgd", 0.0)]
    upd_err = 0.0
    for rule, wd in cases:
        slots0, hyper = rule_state(rule, wd, rows, w, gen, dev)
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
            kernel_t = time_ms(
                lambda: K.fused_rowwise_update(uids, gsum, tk, sk, hyper, rule, n_valid), 50)
            cold = cold_time_ms(
                lambda: K.fused_rowwise_update(uids, gsum, tk, sk, hyper, rule, n_valid),
                COLD_ITERS)
            plain_t = time_ms(
                lambda: K.fused_rowwise_update_plain(uids, gsum, tp, sp, hyper, rule, n_valid),
                20)
            # per touched row: read uid, gsum, table and m||v; write table and m||v
            n_bytes = n_valid * (4 + w * 4 + 2 * (w * 4 + 2 * w * 4))
            bound_ms, bound_by = bound(n_bytes, n_valid * w * 14)
            log(f"[update] {times_text('kernel_ms', kernel_t)} cold_ms={cold:.4f} "
                f"{times_text('plain_ms', plain_t)} "
                f"library_ms=null (no single PyTorch call computes a row-wise Adam "
                f"update) bound_us={bound_ms * 1e3:.2f} ({bound_by}) n_unique={n_valid}")
            records["fused_rowwise_update"] = dict(
                name="fused_rowwise_update", route="cuda",
                source="torecsys_tpu_torch/csrc/sparse_update.cu",
                replaces="torecsys_tpu/ops/pallas/sparse_update.py:50",
                **time_keys("ms", kernel_t), cold_ms=cold, **time_keys("plain_ms", plain_t),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        del tk, sk, tp, sp, slots0
    records["fused_rowwise_update"]["max_abs_err"] = upd_err
    del touched, gsum

    ids = np.stack([batch[f"cat_{i}"] for i in range(len(FIELD_SIZES))], axis=1)
    shifted = torch.from_numpy((ids.astype(np.int64) + field_offsets(FIELD_SIZES)).reshape(-1))
    shifted = shifted.to(dev)
    records["fused_sorted_dedup_update"] = check_fused_dedup(shifted, table0, gen, dev)
    combine_ms = records["widen_segment_sum"]["ms"] + records["fused_rowwise_update"]["ms"]
    log(f"[dedup] adam kernel_ms={records['fused_sorted_dedup_update']['ms']:.4f} against "
        f"widen_segment_sum + fused_rowwise_update = {combine_ms:.4f} (the default "
        f"combine's two kernels, this run)")
    records["fused_sorted_dedup_update"]["sweep"] = sweep_fused_dedup(bench_streams, gen, dev)
    records["unique_stored_gather"] = check_unique_gather(shifted, table0)
    records["unique_stored_gather"]["sweep"] = sweep_unique_gather(shifted, table0)

    records["row_gather"] = check_row_gather(table0, shifted, gen)
    records["row_gather"]["table_grad"] = check_table_grad(table0, shifted, gen)
    del table0, shifted
    torch.cuda.empty_cache()
    return records


def same_bits(a, b) -> bool:
    """Bit-identical float32 tensors (NaN rows included)."""
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def gather_bound(src, idx):
    """(bound_ms, bound_by) of one row gather: each id read once, each
    distinct row (of the ids inside ``[-rows, rows)``, wrapped) read once,
    each output row written once."""
    import torch

    from torecsys_tpu_torch.ops.kernels import embedding as KE

    rows, width = src.shape
    row, valid = KE.wrap_ids(idx, rows)
    distinct = torch.unique(row[valid]).numel()
    num = idx.shape[0]
    return bound(num * idx.element_size() + distinct * width * 4 + num * width * 4, 0)


def gather_times(src, idx, gather=None, library=False):
    """Warm and cold device times of ``gather`` (``row_gather`` where None),
    and where asked the plain version's and ``index_select``'s."""
    from torecsys_tpu_torch.ops.kernels import embedding as KE

    gather = KE.row_gather if gather is None else gather
    out = {"ms": time_ms(lambda: gather(src, idx), 200),
           "cold_ms": cold_time_ms(lambda: gather(src, idx), COLD_ITERS)}
    if library:
        out["plain_ms"] = time_ms(lambda: KE.row_gather_plain(src, idx), 100)
        out["library_ms"] = time_ms(lambda: src.index_select(0, idx), 200)
    return out


def check_row_gather(table0, shifted, gen):
    """``row_gather`` at the main path's shapes, each result bit-identical to
    its plain version: the bench batch's shifted ids into the logical view
    (the lookup), their stored rows into the stored table, and the permute of
    an (M, E) grad stream into id order (int32 and int64 order); then the
    sweep of chunks and reads in flight on the bench lookup and the sweep of
    edge streams.  Returns the lookup's record with ``permute``, ``configs``
    and ``sweep``."""
    import torch

    from torecsys_tpu_torch.ops.kernels import embedding as KE

    dev = table0.device
    w = table0.shape[1]
    m = shifted.shape[0]
    logical = table0.view(-1, EMBED)
    grads = torch.randn(m, EMBED, device=dev, generator=gen)
    order = torch.sort(shifted.to(torch.int32), stable=True).indices
    cases = [("logical view", logical, shifted), ("stored rows", table0, shifted // (w // EMBED)),
             ("permute int64", grads, order), ("permute int32", grads, order.to(torch.int32))]
    record = None
    permute = {}
    for label, src, idx in cases:
        got, ref = KE.row_gather(src, idx), KE.row_gather_plain(src, idx)
        torch.cuda.synchronize()
        if not same_bits(got, ref):
            raise AssertionError(f"row_gather on the {label} is not bit-identical")
        t = gather_times(src, idx, library=True)
        bound_ms, bound_by = gather_bound(src, idx)
        log(f"[gather] {label} {tuple(src.shape)} num={idx.shape[0]} {idx.dtype}: bit-identical "
            f"to the plain version; kernel_ms={t['ms'][0]:.4f} (events {t['ms'][1]:.4f}) "
            f"cold_ms={t['cold_ms']:.4f} {times_text('plain_ms', t['plain_ms'])} "
            f"{times_text('library_ms', t['library_ms'])} (index_select on the same src) "
            f"bound_us={bound_ms * 1e3:.2f} ({bound_by}); cold {bound_ms / t['cold_ms']:.2f} "
            f"of the bound")
        keys = dict(**time_keys("ms", t["ms"]), cold_ms=t["cold_ms"],
                    **time_keys("plain_ms", t["plain_ms"]), bound_ms=bound_ms,
                    bound_by=bound_by, **time_keys("library_ms", t["library_ms"]))
        if label == "logical view":
            record = dict(name="row_gather", route="cuda",
                          source="torecsys_tpu_torch/csrc/embedding.cu",
                          replaces="torecsys_tpu/ops/pallas/embedding.py:40", max_abs_err=0.0,
                          **keys)
        elif label.startswith("permute"):
            permute[label.split()[1]] = keys
    record["permute"] = permute
    record["configs"] = sweep_gather_configs(logical, shifted)
    record["sweep"] = sweep_row_gather(logical, shifted, gen)
    del grads, order
    return record


# The row gather's (chunk, reads in flight) swept on the bench lookup, and
# the pair embedding.cu launches (kChunk, kInFlight)
GATHER_SWEEP = tuple((c, k) for c in (8, 16, 32) for k in (2, 4, 8))
GATHER_DEFAULT = (32, 4)


def sweep_gather(src, idx, chunk: int, in_flight: int):
    """The row gather at another chunk and reads in flight: the sweep build's
    ``trs_row_gather_sweep`` (float4 rows, int64 ids); no launch counted."""
    import ctypes

    import torch

    from torecsys_tpu_torch.ops import kernels as K

    lib = K.load_library(*SWEEP_BUILD)
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.trs_row_gather_sweep.argtypes = [p, p, p, i64, i64, i, i, i, p]
    lib.trs_row_gather_sweep.restype = i
    out = torch.empty(idx.shape[0], src.shape[1], dtype=torch.float32, device=src.device)
    status = lib.trs_row_gather_sweep(K.ptr(src), K.ptr(idx), K.ptr(out), idx.shape[0],
                                      src.shape[0], src.shape[1], chunk, in_flight,
                                      K.current_stream(src.device))
    K.check_status(status, "row_gather sweep")
    return out


def sweep_gather_configs(logical, shifted):
    """The row gather at chunks of 8, 16 and 32 ids a warp and 2, 4 and 8
    reads in flight a lane on the bench lookup: each bit-identical to the
    plain version, warm and cold device times; prints the fastest cold."""
    import functools

    import torch

    from torecsys_tpu_torch.ops.kernels import embedding as KE

    assert shifted.dtype == torch.int64
    ref = KE.row_gather_plain(logical, shifted)
    bound_ms, _ = gather_bound(logical, shifted)
    results = {}
    for chunk, in_flight in GATHER_SWEEP:
        gather = functools.partial(sweep_gather, chunk=chunk, in_flight=in_flight)
        if not same_bits(gather(logical, shifted), ref):
            raise AssertionError(f"row_gather chunk {chunk} x {in_flight}: not bit-identical")
        t = gather_times(logical, shifted, gather)
        label = f"{chunk}x{in_flight}"
        default = " (the one row_gather launches)" if (chunk, in_flight) == GATHER_DEFAULT else ""
        log(f"[gather-config] {label}: chunk {chunk} ids, {in_flight} reads in flight a "
            f"lane{default}: bit-identical; {times_text('kernel_ms', t['ms'])} "
            f"cold_ms={t['cold_ms']:.4f} ({bound_ms / t['cold_ms']:.2f} of the "
            f"{bound_ms * 1e3:.2f} us bound)")
        results[label] = {**time_keys("ms", t["ms"]), "cold_ms": t["cold_ms"]}
    best = min(results, key=lambda k: results[k]["cold_ms"])
    log(f"[gather-config] fastest cold: {best} ({results[best]['cold_ms']:.4f} ms); row_gather "
        f"launches {GATHER_DEFAULT[0]}x{GATHER_DEFAULT[1]}")
    return results


def sweep_row_gather(logical, shifted, gen):
    """``row_gather`` on edge streams, each bit-identical to its plain version
    (int64 and int32 ids) and timed warm and cold beside its bound: M distinct
    ids, one id M times, M in {1, 31, 32, 33, 255, 256, 257} (chunk edges),
    negative ids and ids past the table (NaN rows), width 13 (the 4-byte
    path) and a src offset by one float (misaligned for 16-byte vectors)."""
    import torch

    from torecsys_tpu_torch.ops.kernels import embedding as KE

    dev = logical.device
    rows = logical.shape[0]
    m = shifted.shape[0]

    def ids(n):
        return torch.randint(0, rows, (n,), device=dev, generator=gen)

    spread = torch.arange(m, device=dev) * (rows // m)
    past = torch.randint(-2 * rows, 2 * rows, (m,), device=dev, generator=gen)
    narrow = torch.randn(1 << 20, 13, device=dev, generator=gen)
    flat = torch.randn((1 << 20) * EMBED + 1, device=dev, generator=gen)
    streams = {"distinct": (logical, spread), "one id": (logical, torch.full_like(shifted, 7)),
               **{f"M={n}": (logical, ids(n)) for n in (1, 31, 32, 33, 255, 256, 257)},
               "NaN rows": (logical, past),
               "width 13": (narrow, torch.randint(0, narrow.shape[0], (m,), device=dev,
                                                  generator=gen)),
               "offset pointer": (flat[1:].view(-1, EMBED),
                                  torch.randint(0, 1 << 20, (m,), device=dev, generator=gen))}
    results = {}
    for label, (src, idx) in streams.items():
        for index in (idx, idx.to(torch.int32)):
            if not same_bits(KE.row_gather(src, index), KE.row_gather_plain(src, index)):
                raise AssertionError(f"row_gather sweep {label} {index.dtype}: not bit-identical")
        t = gather_times(src, idx)
        bound_ms, _ = gather_bound(src, idx)
        log(f"[sweep] row_gather {label}: src {tuple(src.shape)} num={idx.shape[0]}; int64 and "
            f"int32 ids bit-identical to the plain version; {times_text('kernel_ms', t['ms'])} "
            f"cold_ms={t['cold_ms']:.4f} bound_us={bound_ms * 1e3:.3f}")
        results[label] = {"num": idx.shape[0], "bound_ms": bound_ms,
                          **time_keys("ms", t["ms"]), "cold_ms": t["cold_ms"]}
    return results


def index_add_table_grad(ids, grad, table_shape):
    """The lookup's backward before: one ``index_add_`` of the wrapped ids
    into a zero logical view (atomics on the card)."""
    from torecsys_tpu_torch.ops.kernels import embedding as KE

    vp, w = table_shape
    rows = vp * (w // grad.shape[1])
    row, valid = KE.wrap_ids(ids, rows)
    grad = grad.masked_fill(~valid[:, None], 0.0)
    return grad.new_zeros(rows, grad.shape[1]).index_add_(0, row, grad).reshape(vp, w)


def check_table_grad(table0, shifted, gen):
    """The lookup's backward (``table_grad``: zero fill, sort, permute, fused
    dedup) at the dense route's shapes: bit-identical to the ``index_add_``
    form on grid cotangents (every partial sum exact), two calls
    bit-identical on real-valued ones; device time of each form (the zero
    fill of the 2.1 GB table included in both)."""
    import torch

    from torecsys_tpu_torch.ops.embedding import table_grad

    shape = table0.shape
    grid = grid_randn((shifted.shape[0], EMBED), gen, table0.device)
    if not torch.equal(table_grad(shifted, grid, shape), index_add_table_grad(shifted, grid, shape)):
        raise AssertionError("table_grad differs from index_add_ on grid cotangents")
    real = torch.randn(shifted.shape[0], EMBED, device=table0.device, generator=gen)
    if not torch.equal(table_grad(shifted, real, shape), table_grad(shifted, real, shape)):
        raise AssertionError("table_grad: two calls differ")
    t = time_ms(lambda: table_grad(shifted, real, shape), 10)
    parent = time_ms(lambda: index_add_table_grad(shifted, real, shape), 10)
    log(f"[table-grad] lookup backward at {tuple(shape)}, M={shifted.shape[0]}: bit-identical to "
        f"index_add_ on grid cotangents, two calls bit-identical; sort + permute + dedup + zero "
        f"fill {times_text('device_ms', t)} vs the index_add_ form "
        f"{times_text('device_ms', parent)}")
    torch.cuda.empty_cache()
    return {**time_keys("ms", t), **time_keys("index_add_ms", parent)}


def rule_state(rule: str, wd: float, rows: int, w: int, gen, dev):
    """Random slots of ``rule`` for a (rows, w) table, and its hyper vector
    (bias correction of step 11)."""
    import torch

    t = 11
    if rule == "adam":
        slot0 = torch.empty(rows, 2, w, device=dev)
        slot0[:, 0].normal_(0.0, 1e-3, generator=gen)
        slot0[:, 1].uniform_(0.0, 1e-5, generator=gen)
        hyper = [1e-3, 0.9, 0.999, 1e-8, wd, 1.0 / (1.0 - 0.9 ** t), 1.0 / (1.0 - 0.999 ** t)]
        return [slot0], torch.tensor(hyper, dtype=torch.float32, device=dev)
    if rule == "adagrad":
        slots0 = [torch.empty(rows, w, device=dev).uniform_(0.1, 1.0, generator=gen)]
        return slots0, torch.tensor([1e-3, 0, 0, 1e-7, 0, 1, 1], dtype=torch.float32, device=dev)
    return [], torch.tensor([1e-3, 0, 0, 0, 0, 1, 1], dtype=torch.float32, device=dev)


def check_fused_dedup(shifted, table0, gen, dev):
    """fused_sorted_dedup_update on the bench batch's ids, sorted on the card
    as the on-device route sorts them, with grid grads: each rule from one
    copied table and slot state, against its plain version."""
    import torch

    from torecsys_tpu_torch.ops.kernels import sparse_update as K

    rows, w = table0.shape
    pack = w // EMBED
    sorted_ids, _ = torch.sort(shifted.to(torch.int32), stable=True)
    m = sorted_ids.shape[0]
    g_sorted = grid_randn((m, EMBED), gen, dev)
    stored = torch.unique(sorted_ids // pack).long()
    n_stored = stored.numel()
    touched = torch.zeros(rows, dtype=torch.bool, device=dev)
    touched[stored] = True
    err_all, record = 0.0, None
    for rule in ("adam", "adagrad", "sgd"):
        slots0, hyper = rule_state(rule, 0.0, rows, w, gen, dev)
        tk, sk = table0.clone(), [s.clone() for s in slots0]
        tp, sp = table0.clone(), [s.clone() for s in slots0]
        K.fused_sorted_dedup_update(sorted_ids, g_sorted, tk, sk, hyper, pack, rule)
        K.fused_sorted_dedup_update_plain(sorted_ids, g_sorted, tp, sp, hyper, pack, rule)
        torch.cuda.synchronize()
        err = 0.0
        for got, ref, orig in [(tk, tp, table0)] + list(zip(sk, sp, slots0)):
            err = max(err, (got - ref).abs().max().item())
            changed = (got != orig).reshape(rows, -1).any(dim=1)
            if bool((changed & ~touched).any()):
                raise AssertionError(f"fused_sorted_dedup_update {rule}: an untouched row changed")
        log(f"[dedup] rule={rule} M={m} stored rows={n_stored} max_abs_err={err:.3g} "
            f"(atol {UPDATE_ATOL}); untouched rows bit-identical")
        if not err <= UPDATE_ATOL:
            raise AssertionError(f"fused_sorted_dedup_update {rule} disagrees: {err}")
        err_all = max(err_all, err)
        if rule == "adam":
            kernel_t = time_ms(lambda: K.fused_sorted_dedup_update(
                sorted_ids, g_sorted, tk, sk, hyper, pack, rule), 50)
            cold = cold_time_ms(lambda: K.fused_sorted_dedup_update(
                sorted_ids, g_sorted, tk, sk, hyper, pack, rule), COLD_ITERS)
            plain_t = time_ms(lambda: K.fused_sorted_dedup_update_plain(
                sorted_ids, g_sorted, tp, sp, hyper, pack, rule), 20)
            # read the sorted ids and narrow grads once; read and write each
            # touched stored row and its m||v once; ~14 float operations per
            # updated element
            bound_ms, bound_by = bound(
                m * 4 + m * EMBED * 4 + n_stored * 2 * (w * 4 + 2 * w * 4), n_stored * w * 14)
            longest = int(torch.unique_consecutive(sorted_ids // pack,
                                                   return_counts=True)[1].max())
            log(f"[dedup] {times_text('kernel_ms', kernel_t)} cold_ms={cold:.4f} "
                f"{times_text('plain_ms', plain_t)} library_ms=null "
                f"(no single PyTorch call dedups and updates) bound_us={bound_ms * 1e3:.3f} "
                f"({bound_by}) longest stored-row group={longest}")
            record = dict(name="fused_sorted_dedup_update", route="cuda",
                          source="torecsys_tpu_torch/csrc/sparse_update.cu",
                          replaces="torecsys_tpu/ops/pallas/sparse_update.py:561",
                          **time_keys("ms", kernel_t), cold_ms=cold,
                          **time_keys("plain_ms", plain_t),
                          bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        del tk, sk, tp, sp, slots0
    record["max_abs_err"] = err_all
    return record


def check_unique_gather(shifted, table0):
    """unique_stored_gather on the bench batch's unique ids (``torch.unique``,
    sorted, padded with the sentinel): the valid prefix must be
    bit-identical to the plain version's."""
    import torch

    from torecsys_tpu_torch.ops.kernels import embedding as KE

    rows, w = table0.shape
    pack = w // EMBED
    m = shifted.shape[0]
    uniq = torch.unique(shifted.to(torch.int32), sorted=True)
    n = uniq.numel()
    uids = torch.full((m,), rows * pack, dtype=torch.int32, device=shifted.device)
    uids[:n] = uniq
    got = KE.unique_stored_gather(table0, uids, EMBED)
    ref = KE.unique_stored_gather_plain(table0, uids, EMBED)
    torch.cuda.synchronize()
    err = (got[:n] - ref[:n]).abs().max().item()
    if not torch.equal(got[:n], ref[:n]):
        raise AssertionError(f"unique_stored_gather is not bit-identical: {err}")
    kernel_t = time_ms(lambda: KE.unique_stored_gather(table0, uids, EMBED), 200)
    cold = cold_time_ms(lambda: KE.unique_stored_gather(table0, uids, EMBED), COLD_ITERS)
    plain_t = time_ms(lambda: KE.unique_stored_gather_plain(table0, uids, EMBED), 100)
    library_t = time_ms(lambda: table0.index_select(0, uids[:n] // pack), 200)
    n_stored = torch.unique(uniq // pack).numel()
    # read the valid ids and each distinct stored row once, write one stored
    # row per valid id
    bound_ms, bound_by = bound(n * 4 + n_stored * w * 4 + n * w * 4, 0)
    log(f"[unique-gather] M={m} valid ids={n} stored rows={n_stored} width={w}: valid prefix "
        f"bit-identical to the plain version; {times_text('kernel_ms', kernel_t)} "
        f"cold_ms={cold:.4f} {times_text('plain_ms', plain_t)} "
        f"{times_text('library_ms', library_t)} (table.index_select(0, "
        f"uids[:n] // P)) bound_us={bound_ms * 1e3:.3f} ({bound_by})")
    return dict(name="unique_stored_gather", route="cuda",
                source="torecsys_tpu_torch/csrc/embedding.cu",
                replaces="torecsys_tpu/ops/pallas/embedding.py:136",
                max_abs_err=err, **time_keys("ms", kernel_t), cold_ms=cold,
                **time_keys("plain_ms", plain_t),
                bound_ms=bound_ms, bound_by=bound_by, **time_keys("library_ms", library_t))


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
    kernel_t = time_ms(lambda: K.segment_sum_wide(wide, seg), 50)
    cold = cold_time_ms(lambda: K.segment_sum_wide(wide, seg), COLD_ITERS)
    plain_t = time_ms(lambda: K.segment_sum_wide_plain(wide, seg), 20)
    library_t = time_ms(lambda: torch.zeros(m, w, device=dev).index_add_(0, seg64, wide), 50)
    bound_ms, bound_by = bound(m * w * 4 + m * 4 + m * w * 4, m * w)
    log(f"[segsum-wide] M={m} W={w} n_unique={n_unique} longest segment={longest}: "
        f"bit-identical to the plain version; {times_text('kernel_ms', kernel_t)} "
        f"cold_ms={cold:.4f} {times_text('plain_ms', plain_t)} "
        f"{times_text('library_ms', library_t)} (torch.zeros(M,W).index_add_) "
        f"bound_us={bound_ms * 1e3:.2f} ({bound_by})")
    return dict(name="segment_sum_wide", route="cuda",
                source="torecsys_tpu_torch/csrc/sparse_update.cu",
                replaces="torecsys_tpu/ops/pallas/sparse_update.py:389",
                max_abs_err=err, **time_keys("ms", kernel_t), cold_ms=cold,
                **time_keys("plain_ms", plain_t),
                bound_ms=bound_ms, bound_by=bound_by, **time_keys("library_ms", library_t))


SWEEP_ITERS = 20
COLD_ITERS = 20


def sweep_streams(bench_seg):
    """The sweep's segment-id streams, int32 on the card, of the bench
    stream's length M (``M = 1`` apart): the bench stream; one segment over
    all M; M distinct segments; tile edges, where segments of T-1, T, T+1 and
    2T+1 positions each start on a warp-tile edge (T = SEGSUM_TILE) and of
    the same lengths in block tiles on a block-tile edge, fillers between;
    and M = 1."""
    import torch

    from torecsys_tpu_torch.ops.kernels import sparse_update as K

    m, dev = bench_seg.shape[0], bench_seg.device
    t = K.SEGSUM_TILE
    bt = t * K.SEGSUM_WARPS
    edges = [t - 1, 1, t, t + 1, t - 1, 2 * t + 1, t - 1, t,
             bt - 1, 1, bt, bt + 1, bt - 1, 2 * bt + 1, bt - 1, bt]
    lens = np.tile(edges, -(-m // sum(edges)))
    tiled = np.repeat(np.arange(lens.size), lens)[:m].astype(np.int32)
    return {"bench": bench_seg,
            "one segment": torch.zeros(m, dtype=torch.int32, device=dev),
            "distinct": torch.arange(m, dtype=torch.int32, device=dev),
            "tile edges": torch.from_numpy(tiled).to(dev),
            "M=1": torch.zeros(1, dtype=torch.int32, device=dev)}


def sweep_segment_sums(bench_streams, gen, dev):
    """Both segment sums on every sweep stream (``widen_segment_sum`` at
    P = 8, E = 16 on the bench's pack-8 stream, ``segment_sum_wide`` at
    W = 128 on its pack-1 stream): grid grads bit-identical to the plain
    version; real-valued grads within (L_s - 1) * 2^-24 * sum|g| of a float64
    sum over each segment of L_s positions; two launches bit-identical.
    Returns each kernel's time and longest segment per stream."""
    import torch

    from torecsys_tpu_torch.ops.kernels import sparse_update as K

    pack = 8
    results = {"widen_segment_sum": {}, "segment_sum_wide": {}}
    for name, bench_pack in (("widen_segment_sum", 8), ("segment_sum_wide", 1)):
        bench_lo, bench_seg = bench_streams[bench_pack]
        for label, seg in sweep_streams(bench_seg).items():
            m = seg.shape[0]
            if name == "widen_segment_sum":
                if label == "bench":
                    lo = bench_lo
                else:  # slots ascending inside each stored row, as ids sort
                    ids = seg.long() * pack + torch.randint(0, pack, (m,), device=dev,
                                                            generator=gen)
                    lo = (torch.sort(ids).values % pack).to(torch.int32)
                width = EMBED
                kernel = lambda x: K.widen_segment_sum(x, lo, seg, pack)  # noqa: E731
                plain = lambda x: K.widen_segment_sum_plain(x, lo, seg, pack)  # noqa: E731
            else:
                width = EMBED_WIDE
                kernel = lambda x: K.segment_sum_wide(x, seg)  # noqa: E731
                plain = lambda x: K.segment_sum_wide_plain(x, seg)  # noqa: E731
            grid = grid_randn((m, width), gen, dev)
            if not torch.equal(kernel(grid), plain(grid)):
                raise AssertionError(f"{name} on the {label} stream: grid grads differ "
                                     f"from the plain version")
            real = torch.randn(m, width, device=dev, generator=gen)
            got = kernel(real)
            if not torch.equal(got, kernel(real)):
                raise AssertionError(f"{name} on the {label} stream: two launches differ")
            err = (got.double() - plain(real.double())).abs()
            lengths = torch.bincount(seg.long(), minlength=got.shape[0]).double()
            limit = (lengths - 1).clamp(min=0)[:, None] * 2.0**-24 * plain(real.abs().double())
            if not bool((err <= limit).all()):
                raise AssertionError(f"{name} on the {label} stream: real-valued grads "
                                     f"outside the float64 bound")
            share = float((err / limit.clamp(min=1e-300)).max())
            longest = int(lengths.max())
            t = time_ms(lambda: kernel(real), SWEEP_ITERS)
            log(f"[sweep] {name} {label}: M={m} longest segment={longest}; grid grads "
                f"bit-identical, two launches bit-identical, real-valued max err "
                f"{float(err.max()):.3g} = {share:.3g} of the float64 bound; "
                f"{times_text('kernel_ms', t)}")
            results[name][label] = {"M": m, "longest": longest, "err_share_of_bound": share,
                                    **time_keys("ms", t)}
        one, bench = results[name]["one segment"]["ms"], results[name]["bench"]["ms"]
        log(f"[sweep] {name}: one segment over all M takes {one / bench:.3f}x the bench "
            f"stream's device time")
    return results


def dedup_sweep_ids(seg, lo, pack: int, label: str, dev):
    """A sweep stream of logical ids for ``fused_sorted_dedup_update``, and the
    table rows R it addresses: group s of ``seg`` becomes stored row 2s + 1
    (the even rows stay untouched) and ``lo`` its in-row slots.  "sentinel
    tail" takes the bench stream and turns its last M/4 positions into
    sentinel ids >= R*P, three to a logical id: groups of 3*P positions past
    the table, crossing tile edges."""
    import torch

    m = seg.shape[0]
    rows = 2 * m + 2
    ids = (2 * seg.long() + 1) * pack + lo.long()
    if label == "sentinel tail":
        tail = m // 4
        ids[m - tail:] = rows * pack + torch.arange(tail, device=dev) // 3
    return ids.to(torch.int32), rows


def sweep_fused_dedup(bench_streams, gen, dev):
    """``fused_sorted_dedup_update`` on every sweep stream of the segment sums
    and a sentinel tail, at P = 8, E = 16 and at P = 1, W = 128, each rule from
    one copied state, on real-valued grads: table and slots bit-identical to
    the default combine (``_combine_sorted_stored``: the segment sum, then
    ``fused_rowwise_update`` with the device count); two launches
    bit-identical; untouched rows, and guard rows past R where the sentinel
    groups' rows would lie, unchanged.  Times adam on each stream beside the
    stream's own bound.  Returns {"P=<pack>": {stream: record}}."""
    import torch

    from torecsys_tpu_torch.ops.kernels import sparse_update as K
    from torecsys_tpu_torch.ops.sparse import _combine_sorted_stored

    results = {}
    for pack, e in ((8, EMBED), (1, EMBED_WIDE)):
        bench_lo, bench_seg = bench_streams[pack]
        streams = sweep_streams(bench_seg)
        streams["sentinel tail"] = bench_seg
        by_stream = {}
        for label, seg in streams.items():
            m = seg.shape[0]
            if seg is bench_seg:
                lo = bench_lo
            else:  # slots ascending inside each stored row, as ids sort
                slots_of = torch.randint(0, pack, (m,), device=dev, generator=gen)
                lo = (torch.sort(seg.long() * pack + slots_of).values % pack).to(torch.int32)
            ids, rows = dedup_sweep_ids(seg, lo, pack, label, dev)
            w = pack * e
            guard = m // 4 + 8
            g = torch.randn(m, e, device=dev, generator=gen)
            hi = ids.long().div(pack, rounding_mode="floor")
            stored = torch.unique(hi[(hi >= 0) & (hi < rows)])
            touched = torch.zeros(rows + guard, dtype=torch.bool, device=dev)
            touched[stored] = True
            table0 = torch.empty(rows + guard, w, device=dev).normal_(0.0, 0.01, generator=gen)
            for rule in ("adam", "adagrad", "sgd"):
                slots0, hyper = rule_state(rule, 0.0, rows + guard, w, gen, dev)

                def run(fn):
                    t, sl = table0.clone(), [s.clone() for s in slots0]
                    fn(t[:rows], [s[:rows] for s in sl])
                    return [t] + sl

                def fused(t, sl):
                    K.fused_sorted_dedup_update(ids, g, t, sl, hyper, pack, rule)

                def combine(t, sl):
                    uids, gsum, n = _combine_sorted_stored(ids, g, pack, rows)
                    K.fused_rowwise_update(uids, gsum, t, sl, hyper, rule, n)

                got, again, ref = run(fused), run(fused), run(combine)
                where = f"fused_sorted_dedup_update P={pack} {label} {rule}"
                for a, b, c, orig in zip(got, again, ref, [table0] + slots0):
                    if not torch.equal(a, b):
                        raise AssertionError(f"{where}: two launches differ")
                    if not torch.equal(a, c):
                        err = (a - c).abs().max().item()
                        raise AssertionError(f"{where}: differs from the default combine "
                                             f"by {err:.3g}")
                    changed = (a != orig).reshape(rows + guard, -1).any(dim=1)
                    if bool((changed & ~touched).any()):
                        raise AssertionError(f"{where}: an untouched or guard row changed")
                del got, again, ref, slots0
            slots0, hyper = rule_state("adam", 0.0, rows, w, gen, dev)
            t = table0[:rows].clone()
            t_ms = time_ms(lambda: K.fused_sorted_dedup_update(ids, g, t, slots0, hyper, pack,
                                                               "adam"), SWEEP_ITERS)
            n_stored = stored.numel()
            bound_ms, bound_by = bound(m * 4 + m * e * 4 + n_stored * 2 * (w * 4 + 2 * w * 4),
                                       n_stored * w * 14)
            longest = int(torch.unique_consecutive(hi, return_counts=True)[1].max())
            log(f"[sweep] fused_sorted_dedup_update P={pack} E={e} {label}: M={m} stored rows "
                f"in the table={n_stored} longest group={longest}; adam, adagrad, sgd: table "
                f"and slots bit-identical to the default combine, two launches "
                f"bit-identical, untouched and guard rows unchanged; adam "
                f"{times_text('kernel_ms', t_ms)} bound_us={bound_ms * 1e3:.3f} ({bound_by}), "
                f"{t_ms[0] / bound_ms:.2f}x the bound")
            by_stream[label] = {"M": m, "stored_rows": n_stored, "longest": longest,
                                "bound_ms": bound_ms, **time_keys("ms", t_ms)}
            del table0, slots0, t, g, touched
        one, bench = by_stream["one segment"]["ms"], by_stream["bench"]["ms"]
        log(f"[sweep] fused_sorted_dedup_update P={pack}: one stored row over all M takes "
            f"{one / bench:.3f}x the bench stream's device time")
        results[f"P={pack}"] = by_stream
    torch.cuda.empty_cache()
    return results


def sweep_unique_gather(shifted, table0):
    """``unique_stored_gather`` on the bench batch's unique ids, on M ids all
    valid, on a single valid id and on a valid prefix that ends inside a
    block's share of ids: the valid prefix bit-identical to
    ``table.index_select(0, uids[:n] // P)``, each stream timed beside its
    bound."""
    import torch

    from torecsys_tpu_torch.ops.kernels import embedding as KE

    rows, w = table0.shape
    pack = w // EMBED
    m, dev = shifted.shape[0], shifted.device
    uniq = torch.unique(shifted.to(torch.int32), sorted=True)
    spread = torch.arange(m, device=dev, dtype=torch.int64) * (rows * pack // m)
    streams = {"bench": uniq, "all valid": spread.to(torch.int32), "single valid": uniq[:1],
               "prefix ends mid-block": uniq[:1013]}
    results = {}
    for label, valid in streams.items():
        n = valid.numel()
        uids = torch.full((m,), rows * pack, dtype=torch.int32, device=dev)
        uids[:n] = valid
        got = KE.unique_stored_gather(table0, uids, EMBED)
        ref = table0.index_select(0, uids[:n].long() // pack)
        if not torch.equal(got[:n], ref):
            raise AssertionError(f"unique_stored_gather {label}: the valid prefix differs "
                                 f"from index_select")
        t = time_ms(lambda: KE.unique_stored_gather(table0, uids, EMBED), 50)
        n_stored = torch.unique(valid.long() // pack).numel()
        bound_ms, _ = bound(n * 4 + n_stored * w * 4 + n * w * 4, 0)
        log(f"[sweep] unique_stored_gather {label}: M={m} valid ids={n} stored rows={n_stored}; "
            f"valid prefix bit-identical to index_select; {times_text('kernel_ms', t)} "
            f"bound_us={bound_ms * 1e3:.3f}, {t[0] / bound_ms:.2f}x the bound")
        results[label] = {"valid": n, "stored_rows": n_stored, "bound_ms": bound_ms,
                          **time_keys("ms", t)}
    return results


# ---- phases 3-7: the trainer's paths ----------------------------------------

def build_trainer(seed: int, sparse: bool = True, embed: int = EMBED, field_sizes=None,
                  presort=None):
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
    trainer = Trainer(pipeline, log_every=10**9, seed=seed, presort=presort)
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
    """Take ``batches`` one step at a time along the kernels' trajectory: from
    the kernels' state before each step, one step with the kernels and one
    with their plain versions; compare the step's loss and the table rows
    ``rows_of`` after it.

    Two runs left to go on alone for several steps are not held: any change
    in the order of a float sum (atomics, tiles) moves the tables by ~1e-9 in
    the first step, and a ReLU whose input lies that close to 0 then flips
    in the next forward, which changes a cotangent by percents and the row it
    updates by up to ~1e-5.  Their divergence is printed as a measurement."""
    import torch

    table = trainer.pipeline.inputs.schema["emb_inputs"].embedding
    start = snapshot(trainer)
    loss_k, loss_p, row_err = [], [], 0.0
    for batch in batches:
        before = snapshot(trainer)
        with plain_versions(fns):
            loss_p += trainer.train_steps([batch])
        rows_p = rows_of(table.detach())
        restore(trainer, before)
        del before
        loss_k += trainer.train_steps([batch])
        row_err = max(row_err, (rows_of(table.detach()) - rows_p).abs().max().item())
    loss_k, loss_p = torch.stack(loss_k).tolist(), torch.stack(loss_p).tolist()
    rows_k = rows_of(table.detach())
    restore(trainer, start)
    del start
    with plain_versions(fns):
        trainer.train_steps(batches)
    free_err = (rows_of(table.detach()) - rows_k).abs().max().item()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(loss_k, loss_p))
    log(f"[{path}] kernels vs plain, {len(batches)} steps each from the kernels' state: losses "
        f"{loss_k} vs {loss_p} (max rel diff {loss_rel:.3g}, rtol {loss_rtol}); "
        f"{rows_k.shape[0]} table rows max_abs_err={row_err:.3g} (atol {rows_atol}); "
        f"left to run alone for {len(batches)} steps the two differ by {free_err:.3g} (not held)")
    if not loss_rel <= loss_rtol:
        raise AssertionError(f"{path}: losses with kernels and plain versions disagree")
    if not row_err <= rows_atol:
        raise AssertionError(f"{path}: table rows with kernels and plain versions disagree")
    return {"loss_kernels": loss_k, "loss_plain": loss_p, "row_max_abs_err": row_err,
            "free_running_row_max_abs_err": free_err}


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
    # row_gather twice a step: the lookup and the grad permute into id order
    check_counts("train", counts, expect(widen_segment_sum=steps, fused_rowwise_update=steps,
                                         row_gather=2 * steps))
    peak = torch.cuda.max_memory_allocated() / 1e9

    prof_info = None
    if profile:
        prof_info = profile_steps(trainer, batches[:3], out_dir, "train")

    cmp_batches = batches[steps:steps + COMPARE_STEPS]
    touched = touched_rows(cmp_batches, table.device)
    compare = compare_with_plain(trainer, cmp_batches, fns, "train",
                                 lambda t: t.index_select(0, touched),
                                 TRAIN_LOSS_RTOL, TRAIN_ROWS_ATOL)
    return trainer, {"launches": counts, "examples_per_sec": eps,
                     "step_ms": BATCH / eps * 1e3, "host_ms_per_step": host,
                     "peak_memory_gb": peak, "losses": loss_vals, "compare": compare,
                     "profile": prof_info}


def touched_rows(batches, dev):
    """The stored rows (P = 8) that ``batches`` touch, as int64 on ``dev``."""
    import torch

    touched = []
    for b in batches:
        _, aux = presorted_stream(b, 8)
        touched.append(torch.from_numpy(aux["uids"][:int(aux["n_unique"][0])]))
    return torch.unique(torch.cat(touched)).to(dev).long()


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
    check_counts("eval", counts, expect(row_gather=EVAL_BATCHES))
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


def phase_ondevice(seed: int, steps: int, presorted_eps: float, out_dir, profile: bool):
    """Phase 5: the on-device sparse route (no host presort), on the default
    combine and on the one-pass fused dedup, on phase 3's batches; then both
    variants with kernels and with plain versions, and the presorted route,
    each step from the on-device kernels' state."""
    import torch

    from torecsys_tpu_torch.data.presort import Presorter, build_presort_specs

    fns = kernels()
    batches = make_batches(seed + 1, steps + COMPARE_STEPS)
    trainer = build_trainer(seed, presort=False)
    table = trainer.pipeline.inputs.schema["emb_inputs"].embedding
    variants = {
        "ondevice": ("0", expect(widen_segment_sum=steps, fused_rowwise_update=steps,
                                 row_gather=2 * steps)),
        "ondevice_fused": ("1", expect(fused_sorted_dedup_update=steps, row_gather=2 * steps)),
    }
    records = {}
    for path, (flag, want) in variants.items():
        torch.cuda.reset_peak_memory_stats()
        with fused_dedup(flag):
            counts, loss_vals, eps, host = timed_steps(trainer, batches[:steps], fns, path)
            peak = torch.cuda.max_memory_allocated() / 1e9
            check_counts(path, counts, want)
            prof_info = profile_steps(trainer, batches[:3], out_dir, path) if profile else None
        log(f"[{path}] examples/sec {eps:.1f} (TORECSYS_TPU_FUSED_DEDUP={flag}) vs the presorted "
            f"route {presorted_eps:.1f} (phase 3), the same model and batches; "
            f"peak_memory_gb={peak:.3f}")
        records[path] = {"launches": counts, "examples_per_sec": eps, "step_ms": BATCH / eps * 1e3,
                         "host_ms_per_step": host, "peak_memory_gb": peak, "losses": loss_vals,
                         "profile": prof_info}

    cmp_batches = batches[steps:]
    presorter = Presorter(build_presort_specs(trainer.pipeline.inputs))
    touched = touched_rows(cmp_batches, table.device)
    # One step at a time along the reference's trajectory (compare_with_plain
    # says why runs left to go on alone are not held); the reference runs
    # last, so the trainer goes on from its state.  The fused kernel sums
    # each stored row in the default combine's order and updates it with the
    # same arithmetic, so its losses, table and slots are held to the bit.
    reference = "on-device, kernels"
    bit_equal = "fused, kernels"
    variants = (("on-device, plain", "0", True, False), (bit_equal, "1", False, False),
                ("fused, plain", "1", True, False), ("presorted, kernels", "0", False, True),
                (reference, "0", False, False))

    def state_rows():
        """The touched rows of the table and of its row-wise slots, side by
        side."""
        parts = [table.detach().index_select(0, touched)]
        for slots in _optimizers(trainer)[1].values():
            parts += [v.detach().index_select(0, touched).reshape(touched.numel(), -1)
                      for v in slots.values()]
        return torch.cat(parts, dim=1)

    def step(flag, plain, presorted, feed):
        feed = [presorter(b) for b in feed] if presorted else feed
        with fused_dedup(flag), (plain_versions(fns) if plain else contextlib.nullcontext()):
            losses = torch.stack(trainer.train_steps(feed)).tolist()
        return losses, state_rows()

    start = snapshot(trainer)
    runs = {label: ([], 0.0, True) for label, *_ in variants}
    for batch in cmp_batches:
        before = snapshot(trainer)
        rows, losses = {}, {}
        for label, *how in variants:
            restore(trainer, before)
            losses[label], rows[label] = step(*how, [batch])
        del before
        for label in runs:
            err = (rows[label] - rows[reference]).abs().max().item()
            same = losses[label] == losses[reference] and torch.equal(rows[label],
                                                                      rows[reference])
            runs[label] = (runs[label][0] + losses[label], max(runs[label][1], err),
                           runs[label][2] and same)
        del rows
    free = {}
    for label, *how in variants[::-1]:  # the reference first
        restore(trainer, start)
        free[label] = step(*how, cmp_batches)[1]
    del start
    loss_ref = runs[reference][0]
    compare = {}
    for label, (losses, row_err, same) in runs.items():
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, loss_ref))
        free_err = (free[label] - free[reference]).abs().max().item()
        held = ("held to the bit: " + ("bit-identical" if same else "NOT bit-identical")
                if label == bit_equal else
                f"max rel diff {loss_rel:.3g}, rtol {TRAIN_LOSS_RTOL}; atol {TRAIN_ROWS_ATOL}")
        log(f"[ondevice] {label} vs {reference}, {COMPARE_STEPS} steps each from the "
            f"reference's state: losses {losses}; {touched.numel()} rows of the table and "
            f"its slots max_abs_err={row_err:.3g} ({held}); left to run alone the two "
            f"differ by {free_err:.3g} (not held)")
        if label == bit_equal and not same:
            raise AssertionError(f"ondevice: {label} is not bit-identical to {reference}")
        if not (loss_rel <= TRAIN_LOSS_RTOL and row_err <= TRAIN_ROWS_ATOL):
            raise AssertionError(f"ondevice: {label} disagrees with the on-device kernels")
        compare[label] = {"losses": losses, "loss_max_rel_diff": loss_rel,
                          "row_max_abs_err": row_err, "bit_identical": same,
                          "free_running_row_max_abs_err": free_err}
    del free
    del trainer, table, runs
    release()
    records["ondevice"]["compare"] = compare
    return records


def phase_dense(seed: int, steps: int, sparse_eps: float, out_dir, profile: bool):
    """Phase 6: the dense-table route at full width."""
    import torch

    fns = kernels()
    batches = make_batches(seed + 1, steps + COMPARE_STEPS)
    torch.cuda.reset_peak_memory_stats()
    trainer = build_trainer(seed, sparse=False)
    counts, loss_vals, eps, host = timed_steps(trainer, batches[:steps], fns, "dense")
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the lookup and its backward's permute; the backward's per-row sum
    check_counts("dense", counts, expect(row_gather=2 * steps, fused_sorted_dedup_update=steps))
    log(f"[dense] examples/sec dense route {eps:.1f} vs sparse route {sparse_eps:.1f} "
        f"(phase 3), the same model and batches; peak_memory_gb={peak:.3f}")
    prof_info = profile_steps(trainer, batches[:3], out_dir, "dense") if profile else None
    repeat = check_repeatable(trainer, batches[steps:], "dense")
    compare = compare_with_plain(trainer, batches[steps:], fns, "dense", lambda t: t.clone(),
                                 DENSE_LOSS_RTOL, DENSE_TABLE_ATOL)
    del trainer
    release()
    return {"launches": counts, "examples_per_sec": eps, "host_ms_per_step": host,
            "peak_memory_gb": peak, "losses": loss_vals, "repeat": repeat, "compare": compare,
            "profile": prof_info}


def check_repeatable(trainer, batches, path: str):
    """Take ``batches`` twice with the kernels from one state: the losses, the
    table and the table's Adam moments must be the same bits (the lookup's
    backward sums each row with one writer, in a fixed order)."""
    import torch

    table = trainer.pipeline.inputs.schema["emb_inputs"].embedding
    dense_opt, _ = _optimizers(trainer)

    def state():
        moments = dense_opt.state[table]
        return [table.detach(), moments["exp_avg"], moments["exp_avg_sq"]]

    start = snapshot(trainer)
    first = torch.stack(trainer.train_steps(batches)).tolist()
    first_state = [t.clone() for t in state()]
    restore(trainer, start)
    second = torch.stack(trainer.train_steps(batches)).tolist()
    same = first == second and all(torch.equal(a, b) for a, b in zip(first_state, state()))
    restore(trainer, start)
    del start, first_state
    log(f"[{path}] two runs of {len(batches)} steps with the kernels from one state: losses "
        f"{first} and {second}; table and its Adam moments "
        f"{'bit-identical' if same else 'NOT bit-identical'}")
    if not same:
        raise AssertionError(f"{path}: two runs from one state differ")
    return {"losses": first, "bit_identical": same}


def phase_pack1(seed: int, out_dir, profile: bool):
    """Phase 7: the pack == 1 sparse route (E = 128, fields capped)."""
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
    check_counts("pack1", counts, expect(fused_rowwise_update=PACK1_STEPS,
                                         row_gather=2 * PACK1_STEPS,
                                         segment_sum_wide=PACK1_STEPS))
    prof_info = profile_steps(trainer, batches[:3], out_dir, "pack1") if profile else None
    del trainer, table
    release()
    return {"launches": counts, "examples_per_sec": eps, "host_ms_per_step": host,
            "peak_memory_gb": peak, "losses": loss_vals, "profile": prof_info}


def profile_steps(trainer, batches, out_dir, path: str):
    """torch.profiler over a few steady steps of ``path``: device time by
    kernel, and the device's busy time as the union of its kernel and copy
    intervals."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_steps(batches)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    n = len(batches)
    device = device_events(prof)
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
    by_kernel = {}
    for name, us in by_name.items():
        kernel = port_kernel(name) or aten_gather(name)
        if kernel:
            by_kernel[kernel] = by_kernel.get(kernel, 0.0) + us / n
    log(f"[profile] {path}, {n} steps: wall {wall_us / n:.1f} us/step (profiler on), "
        f"device busy {busy_us / n:.1f} us/step ({busy_us / wall_us:.3f} of the window)")
    log(f"[profile] {path} in-step device us/step by kernel: "
        + ", ".join(f"{k} {us:.1f}" for k, us in sorted(by_kernel.items()))
        + ("" if "ATen index_select" in by_kernel else "; no ATen index_select gather"))
    for line in lines:
        log(f"[profile] {path} {line}")
    if out_dir:
        attr = ("self_device_time_total"
                if hasattr(prof.key_averages()[0], "self_device_time_total")
                else "self_cuda_time_total")
        with open(os.path.join(out_dir, f"chip_smoke_profile_{path}.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by=attr, row_limit=60))
    return {"wall_us_per_step": wall_us / n, "device_busy_us_per_step": busy_us / n,
            "kernel_us_per_step": by_kernel, "top": lines}


def port_kernel(event: str):
    """The port's kernel that a device event of that name belongs to (its
    CUDA function and template arguments), or None."""
    if "row_gather_kernel" in event:
        return "row_gather"
    if "unique_stored_gather_kernel" in event:
        return "unique_stored_gather"
    if "rowwise_update_kernel" in event:
        return "fused_rowwise_update"
    if "tile_kernel" in event or "fixup_kernel" in event:  # the three tiled kernels
        if "UpdateSink" in event:
            return "fused_sorted_dedup_update"
        return "widen_segment_sum" if "SegKeys<true>" in event else "segment_sum_wide"
    return None


def aten_gather(event: str):
    """The ATen gather kernels a step may run: ``index_select``'s (the grad
    permute before the row gather took it) and the elementwise scatter /
    gather kernel (``_combine_sorted_stored``'s uids ``scatter_``); else
    None."""
    if "vectorized_gather_kernel" in event or "indexSelect" in event:
        return "ATen index_select"
    if "_scatter_gather_elementwise_kernel" in event:
        return "ATen scatter_/gather"
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=None, help="directory for the full JSON record")
    ap.add_argument("--profile", action="store_true",
                    help="trace 3 steps of each training route with torch.profiler")
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
    ondevice = timed("ondevice", phase_ondevice, args.seed, args.steps,
                     train["examples_per_sec"], args.out, args.profile)
    dense = timed("dense", phase_dense, args.seed, args.steps, train["examples_per_sec"],
                  args.out, args.profile)
    pack1 = timed("pack1", phase_pack1, args.seed, args.out, args.profile)
    paths = {"train": train, "eval": evaluation, **ondevice, "dense": dense, "pack1": pack1}
    # Each kernel's launches are those of the path that carries it: the
    # sparse main path (phase 3), the pack == 1 route for segment_sum_wide,
    # the fused on-device route for fused_sorted_dedup_update.
    # unique_stored_gather is on no path of either package (0 everywhere).
    home = {"widen_segment_sum": "train", "fused_rowwise_update": "train",
            "row_gather": "train", "segment_sum_wide": "pack1",
            "unique_stored_gather": "train", "fused_sorted_dedup_update": "ondevice_fused"}
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
