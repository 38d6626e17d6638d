"""The comparison that decides ``correct`` for a training cell.

Both sides read the same things after the same steps from the same weights
and batches (``reference.ctr.train`` for the reference, the configuration's
hooks for the program, ``harness.trainer_run``): the loss of each step,
each leaf's gradient norm at the first step, and the norm of each leaf's
change after the last step.  The steps are the window's own: whole
dispatches of the K-step graph through ``Trainer.train_steps``, the first
of which runs the K steps and captures them and the second replays them,
so a fault of the replay (stale input rows, a state not carried from step
to step, a wrong loss row) shows in them.  The numbers compared:

* ``loss_gap``: the largest ``|loss_p - loss_r| / |loss_r|`` over the steps;
* ``grad_gap``: the worst leaf's ``|g_p - g_r|`` over the larger of the
  reference's norm of that leaf and its median leaf's (some gradients are
  all but zero), ``g`` the first step's gradient norm;
* ``change_gap``: the same of the norms of the leaves' changes.

A leaf whose reference gradient at the first step is under a thousandth of
the median leaf's (a bias ahead of a BatchNorm, which the normalization
cancels: nought to float64's rounding in the reference) is left out of both
gaps: the program's gradient there is its own float32 rounding, and Adam
moves the leaf by that rounding alone.

Running statistics (a BatchNorm's) are not compared: the steps normalize
with the batch's statistics, which the losses and gradients cover, and a
running mean follows the bias ahead of it, which moves by rounding alone.

A leaf that one side lacks is a fault: the number is infinite.
"""

from __future__ import annotations

import math
from statistics import median
from typing import Dict

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
LEAF_NORMS = {"grad_gap": "grad_norms", "change_gap": "change_norms"}
STILL_SHARE = 1e-3


def _learning(grad_norms: Dict[str, float]) -> list:
    floor = median(grad_norms.values())
    return [k for k in grad_norms if grad_norms[k] >= STILL_SHARE * floor]


def _leaf_gaps(p: Dict[str, float], r: Dict[str, float], keys) -> Dict[str, float]:
    floor = median(r[k] for k in keys)
    gaps = {}
    for k in keys:
        if k not in p or k not in r:
            gaps[k] = math.inf
            continue
        gap = abs(p[k] - r[k]) / max(r[k], floor, 1e-30)
        gaps[k] = gap if math.isfinite(gap) else math.inf  # NaN compares false
    return gaps


def _loss_gaps(program: Dict, reference: Dict) -> list:
    lp, lr = program["losses"], reference["losses"]
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lp, lr)]
    if len(lp) != len(lr) or not gaps:
        return [math.inf]
    return [g if math.isfinite(g) else math.inf for g in gaps]


def compare(program: Dict, reference: Dict) -> Dict[str, float]:
    """The numbers (see the module's docstring) of ``program``'s readings
    against ``reference``'s."""
    moved = _learning(reference["grad_norms"])
    out = {"loss_gap": max(_loss_gaps(program, reference))}
    for number, key in LEAF_NORMS.items():
        out[number] = max(_leaf_gaps(program[key], reference[key], moved).values())
    return out


def worst_leaves(program: Dict, reference: Dict) -> Dict[str, str]:
    """The step that sets ``loss_gap`` and the leaf that sets each other
    number."""
    moved = _learning(reference["grad_norms"])
    losses = _loss_gaps(program, reference)
    out = {"loss_gap": f"step {1 + losses.index(max(losses))}"}
    for number, key in LEAF_NORMS.items():
        gaps = _leaf_gaps(program[key], reference[key], moved)
        out[number] = max(gaps, key=gaps.get)
    return out


def still_leaves(reference: Dict) -> list:
    """The leaves left out of the gaps (see the module's docstring)."""
    kept = set(_learning(reference["grad_norms"]))
    return sorted(k for k in reference["grad_norms"] if k not in kept)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """``correct``: every number under its limit (NaN fails)."""
    return all(numbers[k] <= limits[k] for k in NUMBERS)


__all__ = ["NUMBERS", "compare", "judge", "still_leaves", "worst_leaves"]
