"""The port's tracer on the card: its clock, its cost and what its spans read
in the benchmark's cells.

    python3 tools/trace_check.py [--cells a,b] [--seed N] [--seconds S] [--out DIR]

from the root of a checkout, on a machine with an NVIDIA card.  It prints
one JSON line a part and writes them to ``DIR/trace_check.json``:

* ``clock``: the stamp kernel (``csrc/trace.cu``) built, with its ptxas
  report; 2,000 stamps back to back, eager and captured in a CUDA graph:
  monotone, and the least nonzero and the median step between neighbours
  (the least nonzero step bounds ``%globaltimer``'s resolution from above);
  five calibrations' half widths (``utils.trace``);
* for each cell of ``BENCHMARK.json`` named (``h100_bench``'s own set-up:
  traffic, weights, trainer, compared steps and warm-up; one core, one torch
  thread, as ``h100_bench/run.py`` runs): a window of ``S`` seconds with
  tracing off; tracing on, one group that captures the graph again with the
  stamps and whose spans are dropped, a window of ``S`` seconds with tracing
  on and its ``trace_report``; a profiled run of a few dispatches with
  tracing on, where each stamp kernel's start as the profiler records it is
  held to the nearest mark mapped onto the host clock (the two clocks
  joined by the host spans' ``torecsys.step`` ranges); tracing off, a group
  that captures the graph again, a profiled dispatch that must launch no
  stamp kernel, and a last window of ``S`` seconds.  After the first
  window and after the traced one, the card's own ms a step with tracing
  off and on: a few dispatches of one prepared group enqueued behind a spin
  kernel, timed with CUDA events (the host's pace left out).  It prints the
  rates, tracing on against the two windows off, the report, the seven per-layer
  readings the report gives (lookup, sparse update, dense, dense optimizer,
  the idle gap and its input and launch shares) and the reconciliation: the
  device spans' sum a step plus ``other_ms`` plus the gap against the
  traced window's host seconds a step, and against the first untraced
  window's.

``--device cpu --tiny`` rehearses it on the CPU at the benchmark's tests'
tiny size (the marks read the host clock; no kernel, no profiled device).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = ROOT / "h100_bench"
CELLS = ("deepfm_criteo.train", "xdeepfm_criteo.train", "deepfm_criteo.train_longtail")
CLOCK_STAMPS = 2000
CALIBRATIONS = 5
PROFILED_GROUPS = 12
NEAR_US = 20.0
SPIN_CYCLES = 200_000_000   # about 0.1 s of the card's clock
TIMED_DISPATCHES = 6


def steps_stats(values):
    import numpy as np

    d = np.diff(np.asarray(values, dtype=np.int64))
    nonzero = d[d > 0]
    return {"monotone": bool((d >= 0).all()), "least_nonzero_ns": int(nonzero.min()),
            "median_ns": float(np.median(d)), "zero_steps": int((d == 0).sum()),
            "gcd_ns": int(np.gcd.reduce(nonzero))}


def clock(device) -> dict:
    """The stamp kernel's build, its steps back to back and the calibration."""
    import torch

    from torecsys_tpu_torch.ops import kernels
    from torecsys_tpu_torch.ops.kernels import trace as stamp_kernel
    from torecsys_tpu_torch.utils.trace import Tracer

    eager = torch.full((CLOCK_STAMPS,), -1, dtype=torch.int64, device=device)
    for i in range(CLOCK_STAMPS):
        stamp_kernel.stamp(eager, i)
    out = {"eager": steps_stats(eager.tolist())}
    if device.type == "cuda":
        path, report = kernels.build(stamp_kernel.SOURCE)
        out["library"] = path.name
        out["ptxas"] = [ln.strip() for ln in report.splitlines() if "registers" in ln]
        graphed = torch.full((CLOCK_STAMPS,), -1, dtype=torch.int64, device=device)
        graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.graph(graph, stream=stream):
            for i in range(CLOCK_STAMPS):
                stamp_kernel.stamp(graphed, i)
        graph.replay()
        torch.cuda.synchronize(device)
        out["graphed"] = steps_stats(graphed.tolist())
    tracer = Tracer(device)
    cals = [tracer._calibrate() for _ in range(CALIBRATIONS)]
    out["calibration_half_width_us"] = [c[2] / 1e3 for c in cals]
    (d0, h0, _), (d1, h1, _) = cals[0], cals[-1]
    out["offset_change_ns"] = (d1 - h1) - (d0 - h0)
    out["over_ns"] = h1 - h0
    return out


def next_batches(run, groups: int):
    batches = [run.pool[(run.next_index + i) % len(run.pool)] for i in range(groups * run.k)]
    run.next_index += len(batches)
    return batches


def profiled(run, groups: int, cuda: bool):
    """A profiled ``train_steps`` of ``groups`` groups: the profiler's
    events and the tracer's spans of the same dispatches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    trainer = run.trainer
    trainer.spans()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        trainer.train_steps(next_batches(run, groups))
        if cuda:
            torch.cuda.synchronize()
    return prof.events(), trainer.spans()


def alignment(events, spans) -> dict:
    """The profiler's stamp kernels held to the tracer's marks on the host
    clock.  The profiler's clock is joined to ``perf_counter_ns`` by the
    median gap between the midpoints of its ``torecsys.wait`` and
    ``torecsys.step`` ranges and of the host spans they wrap (in order; a
    range opens before its span's first reading and closes after its last,
    by about as much).  Kernels and marks are paired in order where their
    from the last back (the profiler loses the first events of a window);
    ``offset_us`` are the signed gaps, kernel start minus mark; ``agree_ms``
    how long from the first mark the gaps stay within :data:`NEAR_US`;
    ``dump`` both series in µs from the first mark."""
    import numpy as np

    def kind(e):
        return getattr(e.device_type, "name", "")

    names = ("torecsys.wait", "torecsys.step")
    ranges = sorted((e.time_range.start + e.time_range.end) * 500 for e in events
                    if e.name in names and kind(e) == "CPU")
    host = sorted((s.start_ns + s.end_ns) / 2 for s in spans
                  if not s.device and s.name in ("wait", "step") and s.parent is None)
    n = min(len(ranges), len(host))
    if n == 0:
        return {"stamps": 0}
    join = [r - h for r, h in zip(ranges[-n:], host[-n:])]
    offset = statistics.median(join)
    marks = np.array(sorted({t for s in spans if s.device for t in (s.start_ns, s.end_ns)}),
                     dtype=np.float64)
    kernels = np.array(sorted(e.time_range.start * 1e3 - offset for e in events
                              if "stamp_kernel" in e.name and kind(e) == "CUDA"))
    out = {"joins": n, "join_iqr_us": float(np.subtract(*np.percentile(join, [75, 25]))) / 1e3,
           "stamps": int(len(kernels)), "marks": int(len(marks))}
    if not len(kernels) or not len(marks):
        return out
    m = min(len(kernels), len(marks))  # the profiler loses a window's first events
    gaps = (kernels[-m:] - marks[-m:]) / 1e3
    out["dump"] = {"kernels_us": ((kernels - marks[0]) / 1e3).round(3).tolist(),
                   "marks_us": ((marks - marks[0]) / 1e3).round(3).tolist()}
    far = np.flatnonzero(np.abs(gaps) > NEAR_US)
    out["agree_ms"] = float(((marks[-m:][far[0]] if len(far) else marks[-1]) - marks[0]) / 1e6)
    out.update(paired=m,
               offset_us={"median": float(np.median(gaps)), "p5": float(np.percentile(gaps, 5)),
                          "p95": float(np.percentile(gaps, 95)), "min": float(gaps.min()),
                          "max": float(gaps.max())},
               within_20us=float((np.abs(gaps) <= NEAR_US).mean()))
    return out


def device_ms(run, dispatches: int) -> dict:
    """Device ms a step of ``dispatches`` dispatches of one prepared group,
    enqueued behind a spin kernel that holds the card until the host has
    enqueued them all (CUDA events after the spin and after the last)."""
    import torch

    trainer = run.trainer
    group = trainer._prepare(next_batches(run, 1))
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(dispatches):
        trainer._dispatch(group)
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    spin_end = time.perf_counter()
    torch.cuda.synchronize()
    return {"ms_a_step": start.elapsed_time(end) / (dispatches * run.k),
            "enqueue_ms": enqueue_ms, "host_waited_ms": (time.perf_counter() - spin_end) * 1e3}


def readings(report) -> dict:
    """The seven per-layer readings a report gives (ms a step, or % of the
    gap)."""
    span, gap = report["span_ms"], report["gap_ms"]
    by_host = report["gap_by_host"]
    return {
        "lookup_span_ms": span.get("lookup"),
        "sparse_update_span_ms": span.get("sparse_update"),
        "dense_span_ms": span.get("forward", 0.0) + span.get("backward", 0.0),
        "dense_optimizer_span_ms": span.get("dense_optimizer"),
        "device_gap_ms": gap,
        "device_gap_input_pct": 100.0 * by_host["wait"] / gap if gap > 0 else None,
        "device_gap_launch_pct": 100.0 * by_host["step"] / gap if gap > 0 else None,
    }


def cell_check(name: str, seed: int, seconds: float, device, tiny: bool) -> dict:
    import torch

    from harness import cell as cells
    from torecsys_tpu_torch.ops.kernels import trace as stamp_kernel

    cuda = device.type == "cuda"
    if tiny:
        conftest = cells.load_module(BENCH_DIR / "tests" / "conftest.py", "h100_bench_conftest")
        cell = conftest.tiny(name)
    else:
        cell = cells.load(name, ROOT)
    run = cell.model.make_run(cell, device, seed)
    t0 = time.perf_counter()
    run.setup()
    trainer = run.trainer
    out = {"cell": name, "seed": seed, "setup_s": time.perf_counter() - t0}
    launches = stamp_kernel.stamp.launches
    off1 = run.window(seconds)
    timed = {"off": device_ms(run, TIMED_DISPATCHES)} if cuda else {}
    out["stamps_while_off"] = stamp_kernel.stamp.launches - launches

    trainer.set_tracing(True)
    trainer.train_steps(next_batches(run, 1))  # the capture with the stamps
    trainer.spans()
    on = run.window(seconds)
    report = trainer.trace_report()
    if cuda:
        timed["on"] = device_ms(run, TIMED_DISPATCHES)
        timed["on"]["span_ms"] = trainer.trace_report()["span_ms"]
    events, spans = profiled(run, PROFILED_GROUPS, cuda)
    out["alignment"] = alignment(events, spans)

    trainer.set_tracing(False)
    launches = stamp_kernel.stamp.launches
    trainer.train_steps(next_batches(run, 1))  # the capture without them
    events, _ = profiled(run, 1, cuda)
    out["stamps_captured_off"] = stamp_kernel.stamp.launches - launches
    out["stamp_kernels_profiled_off"] = sum("stamp_kernel" in e.name for e in events)
    off2 = run.window(seconds)

    rate_off = (off1["examples_per_s"] + off2["examples_per_s"]) / 2
    sums = sum(report["span_ms"].values()) + report["other_ms"] + report["gap_ms"]
    on_ms, off_ms = on["seconds"] / on["steps"] * 1e3, off1["seconds"] / off1["steps"] * 1e3
    out.update(
        examples_per_s={"off": off1["examples_per_s"], "on": on["examples_per_s"],
                        "off_again": off2["examples_per_s"]},
        tracing_cost_pct=100.0 * (1.0 - on["examples_per_s"] / rate_off),
        host_ms={"off": off1["host_ms"], "on": on["host_ms"]},
        report=report, readings=readings(report),
        reconcile={"spans_other_gap_ms": sums, "traced_window_ms": on_ms,
                   "untraced_window_ms": off_ms,
                   "vs_traced_pct": 100.0 * (sums / on_ms - 1.0),
                   "vs_untraced_pct": 100.0 * (sums / off_ms - 1.0)},
        window_steps={"off": off1["steps"], "on": on["steps"], "off_again": off2["steps"]},
        device_ms=timed,
        device_cost_pct=(100.0 * (timed["on"]["ms_a_step"] / timed["off"]["ms_a_step"] - 1.0)
                         if timed else None),
        graph_stats=trainer.graph_stats)
    if cuda:
        out["peak_device_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    run.free()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--seed", type=int, default=2147483001)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]
    import run as runner

    runner.pin_cpus()
    runner.fixed_caches()
    import torch

    from harness import card

    device = torch.device(args.device)
    if device.type == "cuda":
        card.require_cards(1)
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    torch.set_num_threads(runner.PIN_CPUS)
    lines = {"card": card.card_line() if device.type == "cuda" else "cpu",
             "torch": torch.__version__}
    print(json.dumps(lines), flush=True)
    lines["clock"] = clock(device)
    print(json.dumps({"clock": lines["clock"]}), flush=True)
    for i, name in enumerate(c for c in args.cells.split(",") if c):
        rec = cell_check(name, args.seed + i, args.seconds, device, args.tiny)
        lines[name] = rec
        print(json.dumps(rec), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "trace_check.json"), "w") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
