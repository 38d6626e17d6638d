"""The readings that the limits of ``correct`` are set from, on the card.

    python3 h100_bench/calibrate.py --workload <cell> --seeds 1 2 3 ... [--out FILE]

For each seed, in one process: the program's compared steps from the
seed's weights and batches, as a run's set-up takes them (the K-step
graph's first dispatch and a replay); then the plain
reference in the configuration's precision; the control (the reference one
precision step below, put in the program's place); and the reference with
each planted fault of a training step put in the program's place (its state
left unchanged, half of the batch left out, the loss altered where it is
produced, every step of a K-step dispatch reading its first batch).  Prints one JSON line a seed with each number of each side
against the reference (``harness.check``), and writes them to ``--out``.

A limit lies above the program's largest reading over the seeds and below
the smallest reading of the control, and of each fault that reads ten times
the program's or more (``PERF.md`` gives the readings and the limits).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FAULTS = ("unchanged", "half_batch", "altered_loss", "stale_rows")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]
    from harness import card, cell as cells, check

    cell = cells.load(args.workload, ROOT)
    card.require_cards(cell.workload["chips"])
    import torch

    card.log(f"card: {card.card_line()}; calibrating {cell.name} on seeds {args.seeds}")
    device = torch.device("cuda", 0)
    lines = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = cell.model.make_run(cell, device, seed)
        run.setup(warm=False)
        run.free()
        reference = run.reference("stated")
        control = run.reference("control")
        line = {"seed": seed, "program": check.compare(run.readings, reference),
                "control": check.compare(control, reference),
                "left_out": check.still_leaves(reference),
                "program_worst": check.worst_leaves(run.readings, reference),
                "control_worst": check.worst_leaves(control, reference)}
        for fault in FAULTS:
            line[fault] = check.compare(run.reference("stated", fault), reference)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        lines.append(line)
        del run
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    for side in ("program", "control", *FAULTS):
        for k in check.NUMBERS:
            values = [x[side][k] for x in lines]
            card.log(f"{side:13s} {k:10s} min {min(values):.6g} max {max(values):.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
