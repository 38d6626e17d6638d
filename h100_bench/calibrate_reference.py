"""The reference's side of the readings that the limits of ``correct`` are
set from, for a cell whose program needs more cards than one.

    python3 h100_bench/calibrate_reference.py --workload <cell> --seeds 1 2 3 ... [--out FILE]

``calibrate.py`` reads the program, the control and the planted faults of
each seed against the plain reference in one process, so it sets the
program up for every seed.  The control and the faults do not involve the
program: they are the reference one precision step below and the reference
with each fault of ``reference`` planted.  This runs them alone, on one
card, from each seed's weights and batches, and prints one JSON line a seed
as ``calibrate.py`` does, without the program's numbers (the cell's own
runs print those, ``run.py``'s ``check``).  Besides ``calibrate.py``'s four
faults it plants ``no_exchange``, which only a cell on a mesh can have: the
psum of the bag sums left out, rank 0's sums holding its own rows alone.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FAULTS = ("unchanged", "half_batch", "altered_loss", "stale_rows", "no_exchange")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]
    from harness import card, cell as cells, check

    cell = cells.load(args.workload, ROOT)
    card.require_cards(1)
    import torch

    card.log(f"card: {card.card_line()}; the reference's side of {cell.name} on seeds "
             f"{args.seeds}")
    device = torch.device("cuda", 0)
    lines = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = cell.model.make_run(cell, device, seed)
        reference = run.reference("stated")
        line = {"seed": seed, "control": check.compare(run.reference("control"), reference),
                "left_out": check.still_leaves(reference)}
        for fault in FAULTS:
            line[fault] = check.compare(run.reference("stated", fault), reference)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        lines.append(line)
        del run
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    for side in ("control", *FAULTS):
        for k in check.NUMBERS:
            values = [x[side][k] for x in lines]
            card.log(f"{side:13s} {k:10s} min {min(values):.6g} max {max(values):.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
