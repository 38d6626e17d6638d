"""Probe cuDNN's convolutions at the image tower's shapes, and the image-tower
DeepFM's step with cuDNN's convolution backward in place of the port's.

It measured the fault that made the port's ``ImageInput`` convolutions its
own (``inputs/image.py`` ``_Conv2d``, the backward first, the forward
since); it still runs cuDNN under the flags the tower once ran it with
(:func:`_conv_flags`).  This script asks two questions on the
card, each in one run:

1. Does cuDNN, with deterministic algorithms asked for, give the same bits
   for one convolution whatever memory is free?  Each scenario runs in a
   child process of its own (cuDNN's plan cache starts empty), with cuDNN's
   API log on: the forward and the backward of the tower's two convolutions
   (batch 4096, 64x64x3 and 32x32x32 inputs, 3x3, ``channels_last``,
   float32, TF32 off) on inputs made from ``--seed``; ``repeat`` with all
   memory free, ``headroom_<MiB>`` with that much free beyond each call's
   outputs, ``squeeze`` three calls in one process: all free, then no
   headroom, then all free again.  Each result's checksum is printed.
2. What does the step cost with cuDNN's backward?  The image-tower DeepFM
   of ``chip_smoke.py`` phase 22 (bench widths, batch 4096, on-device
   route, K = 8) timed over 16 graphed steps with the port's backward and
   with cuDNN's (``aten.convolution_backward`` under the port's flags), in
   the order port, cuDNN, cuDNN, port; and for cuDNN's, one replay against
   its 8 eager steps.

Run on the card: ``python3 tools/torch_conv_probe.py [--out DIR]``.  The
last lines are the card's name and power limit and one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4096
# (name, in channels, out channels, size): the JAX default tower on 64x64x3
CONVS = (("conv_0", 3, 32, 64), ("conv_1", 32, 64, 32))
HEADROOM_MIB = (8192, 1024, 128, 16, 0)
SLACK = 64 << 20  # left free beyond the outputs and the headroom
MIB = 1 << 20
CHUNK = 1 << 26



def _conv_flags():
    """cuDNN's flags of the tower's convolutions when they were cuDNN's:
    float32 (TF32 off), deterministic algorithms, no benchmarking."""
    import torch

    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                      allow_tf32=False)

def checksum(t) -> str:
    """Two int64 sums of the tensor's 32-bit words (plain and weighted by
    position), taken on the card in chunks: equal bits, equal sums."""
    import torch

    words = t.detach().contiguous().view(-1).view(torch.int32)
    plain = weighted = 0
    for i in range(0, words.numel(), CHUNK):
        v = words[i:i + CHUNK].long()
        pos = torch.arange(i, i + v.numel(), device=v.device) % 1_000_003 + 1
        plain += int(v.sum())
        weighted += int((v * pos).sum())
    return f"{plain & (2**64 - 1):016x}{weighted & (2**64 - 1):016x}"


def conv_inputs(seed: int):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name, cin, cout, size in CONVS:
        x = torch.randn(BATCH, cin, size, size, device="cuda", generator=g)
        w = torch.randn(cout, cin, 3, 3, device="cuda", generator=g) / (9 * cin) ** 0.5
        b = torch.randn(cout, device="cuda", generator=g)
        dy = torch.randn(BATCH, cout, size, size, device="cuda", generator=g)
        cl = torch.channels_last
        out[name] = tuple(t.contiguous(memory_format=cl) for t in (x, w)) + (
            b, dy.contiguous(memory_format=cl))
    return out


class Squeeze:
    """Holds all the card's free memory but ``keep`` bytes (None: holds
    nothing)."""

    def __init__(self, keep):
        self.keep, self.blob = keep, None

    def __enter__(self):
        import torch

        if self.keep is None:
            return self
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info()[0]
        size = free - self.keep
        while size > 0 and self.blob is None:
            try:
                self.blob = torch.empty(size, dtype=torch.uint8, device="cuda")
            except torch.cuda.OutOfMemoryError:
                size -= 2 * MIB
        return self

    def __exit__(self, *exc):
        import torch

        self.blob = None
        torch.cuda.empty_cache()


def run_convs(inputs, headroom):
    """Forward and backward of each convolution under the port's flags, each
    call with ``headroom`` bytes free beyond its outputs (None: all free):
    ``{conv: {part: checksum}}`` and the free bytes each call saw."""
    import torch
    import torch.nn.functional as F


    out, seen = {}, {}
    for name, (x, w, b, dy) in inputs.items():
        fwd_bytes = dy.numel() * 4
        bwd_bytes = (x.numel() + w.numel() + b.numel()) * 4
        with Squeeze(None if headroom is None else fwd_bytes + headroom + SLACK):
            seen[f"{name}_fwd_free_mib"] = torch.cuda.mem_get_info()[0] / MIB
            with _conv_flags():
                y = F.conv2d(x, w, b, 1, 1)
            torch.cuda.synchronize()
        fwd = checksum(y)
        del y
        with Squeeze(None if headroom is None else bwd_bytes + headroom + SLACK):
            seen[f"{name}_bwd_free_mib"] = torch.cuda.mem_get_info()[0] / MIB
            with _conv_flags():
                gx, gw, gb = torch.ops.aten.convolution_backward(
                    dy, x, w, [w.shape[0]], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                    [True, True, True])
            torch.cuda.synchronize()
        out[name] = {"forward": fwd, "grad_input": checksum(gx), "grad_weight": checksum(gw),
                     "grad_bias": checksum(gb)}
        out[name]["_gw"] = gw.double().cpu()
        del gx, gw, gb
    return out, seen


def child(scenario: str, seed: int) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inputs = conv_inputs(seed)
    if scenario == "repeat":
        levels = [None] * 3
    elif scenario == "squeeze":
        levels = [None, 0, None]
    else:
        levels = [int(scenario.split("_")[1]) * MIB] * 2
    calls = []
    for level in levels:
        result, seen = run_convs(inputs, level)
        calls.append((result, seen))
    first = calls[0][0]
    record = {"scenario": scenario, "cudnn": torch.backends.cudnn.version(),
              "torch": torch.__version__, "calls": []}
    for result, seen in calls:
        diff = {n: float((result[n]["_gw"] - first[n]["_gw"]).abs().max()) for n in result}
        record["calls"].append({
            "free_mib": seen, "max_abs_grad_weight_diff_to_first": diff,
            "checksum": {n: {k: v for k, v in r.items() if not k.startswith("_")}
                    for n, r in result.items()}})
    print("PROBE " + json.dumps(record), flush=True)


ENGINE = re.compile(r"(GLOBAL_INDEX[^\n]{0,40}|eng\d+[\w=,\-]*)")


def cause(seed: int, out_dir: str):
    """Part 1: each scenario in a child process with cuDNN's API log."""
    scenarios = ["repeat", "squeeze"] + [f"headroom_{m}" for m in HEADROOM_MIB]
    records = []
    for s in scenarios:
        log_path = os.path.join(out_dir, f"cudnn_{s}.log")
        env = dict(os.environ, CUDNN_LOGLEVEL_DBG="3", CUDNN_LOGDEST_DBG=log_path,
                   CUDNN_LOGINFO_DBG="1", TORCH_CUDNN_V8_API_DEBUG="1")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", s,
                               "--seed", str(seed)], env=env, capture_output=True, text=True,
                              timeout=600, cwd=ROOT)
        line = [x for x in proc.stdout.splitlines() if x.startswith("PROBE ")]
        if proc.returncode != 0 or not line:
            raise RuntimeError(f"{s}: rc {proc.returncode}\n{proc.stderr[-3000:]}")
        rec = json.loads(line[-1][6:])
        engines = {}
        for m in ENGINE.findall(proc.stderr):
            engines[m] = engines.get(m, 0) + 1
        with open(os.path.join(out_dir, f"child_{s}.stderr"), "w") as f:
            f.write(proc.stderr[:1 << 20])
        if os.path.exists(log_path):
            with open(log_path, errors="replace") as f:
                text = f.read()
            rec["cudnn_log_bytes"] = len(text)
            for m in ENGINE.findall(text):
                engines[m] = engines.get(m, 0) + 1
            with open(log_path, "w") as f:  # keep the head only
                f.write(text[:1 << 20])
        rec["engine_mentions"] = dict(sorted(engines.items(), key=lambda kv: -kv[1])[:40])
        rec["seconds"] = time.perf_counter() - t0
        print(f"[cause] {s}: " + json.dumps({k: v for k, v in rec.items()
                                             if k != "engine_mentions"}), flush=True)
        records.append(rec)
    base = records[0]["calls"][0]["checksum"]
    for rec in records:
        rec["same_as_repeat"] = [c["checksum"] == base for c in rec["calls"]]
    return records


def cudnn_backward(ctx, grad):
    """``_Conv2d``'s backward by cuDNN (``aten.convolution_backward``)
    under the port's flags."""
    import torch


    x, weight = ctx.saved_tensors
    with _conv_flags():
        gx, gw, gb = torch.ops.aten.convolution_backward(
            grad, x, weight, [weight.shape[0]], [ctx.stride] * 2, [ctx.padding] * 2, [1, 1],
            False, [0, 0], 1, [ctx.needs_input_grad[0], True, True])
    return gx, gw, gb, None, None


def step_cost(seed: int):
    """Part 2: the image-tower DeepFM's graphed step with each backward."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from torecsys_tpu_torch import Trainer
    from torecsys_tpu_torch.inputs import image

    cs.phase_build()
    k = cs.GRAPH_K
    batches = cs.image_batches(seed + 23, 2 * k)
    warm, group = batches[:k], batches[k:]
    port = image._Conv2d.backward
    runs = []
    for which in ("port", "cudnn", "cudnn", "port"):
        image._Conv2d.backward = staticmethod(cudnn_backward if which == "cudnn" else port)
        try:
            torch.cuda.reset_peak_memory_stats()
            trainer = Trainer(cs.image_pipeline(sparse=None), log_every=10**9, seed=seed,
                              steps_per_execution=k)
            trainer.init_state()
            trainer.train_steps(warm)  # warm-up and capture
            eps, host = cs.timed_dispatches(trainer, group * 2, f"image_{which}", k)
            run = {"backward": which, "examples_per_sec": eps,
                   "step_ms": BATCH / eps * 1e3, "host_ms_per_step": host,
                   "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
            if which == "cudnn" and not any(r["backward"] == "cudnn" for r in runs):
                start = cs.snapshot(trainer)
                try:
                    cs.replay_vs_eager(trainer, group, start, "image_cudnn")
                    run["replay_equals_eager"] = True
                except AssertionError as e:
                    run["replay_equals_eager"] = False
                    run["replay_error"] = str(e)
                del start
            cs.log(f"[step] {json.dumps(run)}")
            runs.append(run)
            del trainer
            cs.release()
        finally:
            image._Conv2d.backward = staticmethod(port)
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "conv_probe"))
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_conv_probe: no CUDA device; the probe runs on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    if args.child:
        child(args.child, args.seed)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    records = cause(args.seed, args.out)
    steps = step_cost(args.seed)
    result = {"card": card, "cause": records, "step": steps,
              "seconds": time.perf_counter() - t0}
    with open(os.path.join(args.out, "conv_probe.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(card)
    print(json.dumps({"same_as_repeat": {r["scenario"]: r["same_as_repeat"] for r in records},
                      "step_ms": {f"{i}_{r['backward']}": r["step_ms"]
                                  for i, r in enumerate(steps)},
                      "replay_equals_eager_cudnn": [r.get("replay_equals_eager")
                                                    for r in steps if r["backward"] == "cudnn"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
