"""One run of one cell of the benchmark of ``torecsys_tpu_torch`` on NVIDIA cards.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's files are found by the names in
``BENCHMARK.json`` (``harness.cell``).  The run:

1. fails with exit code 2, printing no result, where CUDA is unavailable or
   the machine shows fewer cards than the cell asks for;
2. keeps to :data:`PIN_CPUS` of the machine's cores and as many threads;
3. sets up through the configuration's ``make_run`` hook
   (``harness.trainer_run.TrainerRun.setup``): the traffic pool and the
   weights from ``--seed``, the program's trainer, its compared steps (the
   K-step graph's capture and a replay) and their readings, a warm-up
   replay.  ``setup_s`` runs from the process's start to the end of set-up;
4. measures for ``--seconds`` seconds: the end-to-end metrics with
   ``--trace 0``; with ``--trace 1`` then traces a shorter segment under
   the profiler, and reports the per-layer metrics (those of the host and
   the whole step's share of the peak from the untraced window, those of
   the device from the trace), ``busy_s`` and ``window_s``, the
   ``breakdown``;
5. reads the peak device memory, frees the program, runs the plain
   reference on the same weights and batches and compares
   (``harness.check``): ``correct``;
6. fails with exit code 3, printing no result, where JAX, flax, optax or
   the JAX package was loaded;
7. prints each number compared beside its limit as its last lines on
   standard error, and the result as one JSON object, the last line of
   standard output, its ``check`` key last.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

T_IMPORT = time.time()
BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE_DIR = ROOT / "build" / "h100_bench_cache"
if __name__ == "__main__":
    # Python's bytecode of every module the run imports, the program's and
    # torch's among them, cached inside the checkout at a fixed path: a host
    # whose installation keeps none compiles some thousand files every run.
    sys.pycache_prefix = str(CACHE_DIR / "pycache")
    sys.dont_write_bytecode = False

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402

PIN_CPUS = 1


def process_start() -> float:
    """The wall-clock time the process started (``/proc/self/stat``), or
    this module's import where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            after_name = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + int(after_name[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def pin_cpus() -> None:
    """Keep the process, and the threads it starts, to the last
    :data:`PIN_CPUS` cores it may use (all where it may use fewer)."""
    cpus = sorted(os.sched_getaffinity(0))
    if PIN_CPUS and len(cpus) > PIN_CPUS:
        os.sched_setaffinity(0, cpus[-PIN_CPUS:])


def fixed_caches() -> None:
    """Every kernel cache inside the checkout, at fixed paths (the port's own
    nvcc libraries go to ``build/torch_kernels`` there by themselves)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE_DIR / sub)
    os.environ["USE_FLAX"] = "0"


def finite(x: float) -> float:
    """``x``, or the largest float where it is not finite (JSON has no inf)."""
    return x if math.isfinite(x) else sys.float_info.max


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class Segment:
    """What a per-layer metric's reader reads: the traced segment's device
    window and its steps; the untraced window's seconds a step and the
    host's ms a step by stage (``Trainer.host_ms``); the bytes a step of
    the traced batches and the operations a step of the window's, by the
    configuration's counts."""

    def __init__(self, device, steps, step_s, host_ms, bytes_per_step, ops_per_step):
        self.device, self.steps, self.step_s, self.host_ms = device, steps, step_s, host_ms
        self.bytes, self.ops = bytes_per_step, ops_per_step


def execute(cell, seed: int, seconds: float, trace: bool, device, start: float) -> dict:
    """Set up, measure (and trace), then check: the result's object, its
    ``check`` key last (on the CPU, for tests, a device reading of 0)."""
    import torch

    from harness import card, check

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
        card.log(f"CUDA context at {time.time() - start:.3f} s")
    run = cell.model.make_run(cell, device, seed)
    run.setup()
    setup_s = time.time() - start
    card.log(f"set-up {setup_s:.3f} s; compared steps' losses {run.readings['losses']}")
    window = run.window(seconds)
    card.log(f"window {window['seconds']:.3f} s, {window['steps']} steps, "
             f"{window['intervals']} dispatch intervals; host ms a step {window['host_ms']}")
    result = {"correct": False, "attempted": window["steps"], "failed": window["failed"],
              "metrics": {}}
    if trace:
        traced = run.traced()
        cfg, batch = cell.config, cell.mix["batch_size"]
        seg = Segment(traced["device"], traced["steps"], window["seconds"] / window["steps"],
                      window["host_ms"],
                      cell.model.bytes_per_step(cfg, run.stats(traced["batches"])),
                      cell.model.ops_per_step(cfg, batch, run.stats(window["batches"])))
        for metric in cell.per_layer:
            value = cell.readers[metric["name"]].read(seg)
            if value is not None:
                result["metrics"][metric["name"]] = {"value": value, "unit": metric["unit"]}
        result["attempted"] += traced["steps"]
        result["failed"] += traced["failed"]
    else:
        values = {"setup_s": setup_s, "train_examples_per_s": window["examples_per_s"],
                  "train_step_p95_ms": window["step_p95_ms"],
                  "peak_device_gb": torch.cuda.max_memory_allocated(device) / 1e9 if cuda else 0.0}
        for metric in cell.end_to_end:
            result["metrics"][metric["name"]] = {"value": values[metric["name"]],
                                                 "unit": metric["unit"]}
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": cell.workload["chips"],
        "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0}
    if trace:
        result["device"].update(busy_s=seg.device.busy_s, window_s=seg.device.window_s)
        result["breakdown"] = seg.device.breakdown()
    run.free()
    t_ref = time.perf_counter()
    reference = run.reference()
    numbers = check.compare(run.readings, reference)
    card.log(f"reference {time.perf_counter() - t_ref:.3f} s; reference losses "
             f"{reference['losses']}; left out of the gaps: {check.still_leaves(reference)}; "
             f"worst: {check.worst_leaves(run.readings, reference)}")
    result["correct"] = check.judge(numbers, cell.limits) and result["failed"] == 0
    result["check"] = {k: {"value": finite(numbers[k]), "limit": cell.limits[k]}
                       for k in check.NUMBERS}
    return result


def main(argv=None) -> int:
    start = process_start()
    args = parse(argv)
    pin_cpus()
    fixed_caches()
    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]
    from harness import card, cell as cells, guard

    cell = cells.load(args.workload, ROOT)
    card.log(f"imports and the cell's files at {time.time() - start:.3f} s")
    try:
        card.require_cards(cell.workload["chips"])
    except card.NoCard as err:
        card.log(f"no run: {err}")
        return 2
    import torch

    if PIN_CPUS:
        torch.set_num_threads(PIN_CPUS)
    card.log(f"card: {card.card_line()}; cell {cell.name}, seed {args.seed}, "
             f"{args.seconds} s, trace {args.trace}; cores {sorted(os.sched_getaffinity(0))}, "
             f"{torch.get_num_threads()} threads; {time.time() - start:.3f} s since the "
             "process started")
    result = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                     start)
    loaded = guard.forbidden_loaded()
    if loaded:
        card.log(f"no result: the process loaded {loaded}")
        return 3
    for name, c in result["check"].items():
        card.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
