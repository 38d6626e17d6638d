"""Learning-rate schedules: twins of optax's, under optax's names and
arguments, for ``learning_rate`` of the optimizers in
:mod:`torecsys_tpu_torch.train.optimizers`.

A schedule is a callable ``count -> learning rate``.  ``count`` is a 0-d
integer tensor on the parameters' device (the optimizer's own count, optax's
``ScaleByScheduleState.count``: 0 at the first update) or a Python int; the
value is a 0-d float32 tensor on ``count``'s device, computed with tensor
operations in float32 in optax's order, as jitted optax computes it from its
int32 count (one difference: at the end of a ``polynomial_schedule`` of a
fractional ``power`` jitted optax gives NaN, as XLA takes ``count / steps``
as ``count * (1 / steps)``, one minus that comes out about -1.5e-8, and its
fractional power is NaN; here the end is ``end_value``).  Nothing is read
back to the host and nothing is copied to the card (constants are fills),
so a step captured in a CUDA graph evaluates the schedule at each replay's
own count; a Python float computed on the host would freeze into the graph.

``constant_schedule``, ``linear_schedule``, ``polynomial_schedule``,
``exponential_decay``, ``cosine_decay_schedule``,
``piecewise_constant_schedule``, ``piecewise_interpolate_schedule``,
``join_schedules``, ``warmup_constant_schedule``,
``warmup_cosine_decay_schedule``, ``warmup_exponential_decay_schedule``,
``sgdr_schedule``, ``linear_onecycle_schedule``, ``cosine_onecycle_schedule``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Sequence, Union

import numpy as np
import torch

Count = Union[int, torch.Tensor]
Schedule = Callable[[Count], torch.Tensor]


def _count(count: Count) -> torch.Tensor:
    """``count`` as a 0-d int32 tensor (optax's count dtype)."""
    if isinstance(count, torch.Tensor):
        return count.to(torch.int32)
    return torch.tensor(int(count), dtype=torch.int32)


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant on ``like``'s device: a fill, not a copy from the
    host, which a CUDA graph capture refuses."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def constant_schedule(value: float) -> Schedule:
    def schedule(count):
        return _f32(value, _count(count))
    return schedule


def polynomial_schedule(init_value: float, end_value: float, power: float,
                        transition_steps: int, transition_begin: int = 0) -> Schedule:
    if transition_steps <= 0:
        return constant_schedule(init_value)
    transition_begin = max(transition_begin, 0)

    def schedule(count):
        c = torch.clamp(_count(count) - transition_begin, 0, transition_steps)
        frac = 1 - c.float() / transition_steps
        return (init_value - end_value) * frac ** power + end_value
    return schedule


def linear_schedule(init_value: float, end_value: float, transition_steps: int,
                    transition_begin: int = 0) -> Schedule:
    return polynomial_schedule(init_value, end_value, 1, transition_steps, transition_begin)


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float,
                      transition_begin: int = 0, staircase: bool = False,
                      end_value: Optional[float] = None) -> Schedule:
    if transition_steps <= 0 or decay_rate == 0:
        return constant_schedule(init_value)
    transition_begin = max(transition_begin, 0)
    clip = torch.maximum if decay_rate < 1.0 else torch.minimum

    def schedule(count):
        dec = _count(count) - transition_begin
        p = dec.float() / transition_steps
        if staircase:
            p = torch.floor(p)
        value = torch.where(dec <= 0, _f32(init_value, dec),
                            init_value * torch.pow(_f32(decay_rate, dec), p))
        if end_value is not None:
            value = clip(value, _f32(end_value, dec))
        return value
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0,
                          exponent: float = 1.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={decay_steps}.")
    steps = float(decay_steps)

    def schedule(count):
        c = torch.clamp_max(_count(count).float(), steps)
        cosine = 0.5 * (1 + torch.cos(math.pi * c / steps))
        return init_value * ((1 - alpha) * cosine ** exponent + alpha)
    return schedule


def piecewise_constant_schedule(init_value: float,
                                boundaries_and_scales: Optional[Dict[int, float]] = None
                                ) -> Schedule:
    if boundaries_and_scales is not None and not all(
            s >= 0.0 for s in boundaries_and_scales.values()):
        raise ValueError("`piecewise_constant_schedule` expects non-negative scale factors")

    def schedule(count):
        c = _count(count)
        v = _f32(init_value, c)
        for threshold, scale in sorted((boundaries_and_scales or {}).items()):
            indicator = torch.clamp_min(torch.sign(threshold - c).float(), 0.0)
            v = v * indicator + (1 - indicator) * scale * v
        return v
    return schedule


def _linear_interpolate(start, end, pct):
    return (end - start) * pct + start


def _cosine_interpolate(start, end, pct):
    return end + (start - end) / 2.0 * (torch.cos(math.pi * pct) + 1)


def piecewise_interpolate_schedule(interpolate_type: str, init_value: float,
                                   boundaries_and_scales: Optional[Dict[int, float]] = None
                                   ) -> Schedule:
    if interpolate_type == "linear":
        interpolate = _linear_interpolate
    elif interpolate_type == "cosine":
        interpolate = _cosine_interpolate
    else:
        raise ValueError("`interpolate_type` must be either 'cosine' or 'linear'")
    if boundaries_and_scales:
        boundaries, scales = zip(*sorted(boundaries_and_scales.items()))
        if not all(s >= 0.0 for s in scales):
            raise ValueError("`piecewise_interpolate_schedule` expects non-negative scale "
                             "factors")
    else:
        boundaries, scales = (), ()
    bounds = np.stack((0,) + boundaries)
    # optax takes the cumulative product in float64 and XLA rounds it to float32
    values = np.cumprod(np.stack((init_value,) + scales)).astype(np.float32)
    consts = {}  # per device, made at the first (eager) call, before any capture

    def schedule(count):
        c = _count(count)
        if c.device not in consts:
            consts[c.device] = (torch.as_tensor(bounds[:-1], dtype=torch.int32, device=c.device),
                                torch.as_tensor(bounds[1:], dtype=torch.int32, device=c.device),
                                torch.as_tensor(values, device=c.device))
        lo, hi, vals = consts[c.device]
        indicator = ((lo <= c) & (c < hi)).float()
        pct = (c - lo).float() / (hi - lo).float()
        interp = interpolate(vals[:-1], vals[1:], pct)
        return (indicator * interp).sum() + (int(bounds[-1]) <= c).float() * vals[-1]
    return schedule


def join_schedules(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    def schedule(count):
        c = _count(count)
        out = schedules[0](c)
        for boundary, s in zip(boundaries, schedules[1:]):
            out = torch.where(c < boundary, out, s(c - boundary))
        return out
    return schedule


def warmup_constant_schedule(init_value: float, peak_value: float,
                             warmup_steps: int) -> Schedule:
    return linear_schedule(init_value, peak_value, warmup_steps)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules([
        linear_schedule(init_value, peak_value, warmup_steps),
        cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha, exponent),
    ], [warmup_steps])


def warmup_exponential_decay_schedule(init_value: float, peak_value: float,
                                      warmup_steps: int, transition_steps: int,
                                      decay_rate: float, transition_begin: int = 0,
                                      staircase: bool = False,
                                      end_value: Optional[float] = None) -> Schedule:
    return join_schedules([
        linear_schedule(init_value, peak_value, warmup_steps),
        exponential_decay(peak_value, transition_steps, decay_rate, transition_begin,
                          staircase, end_value),
    ], [warmup_steps])


def sgdr_schedule(cosine_kwargs: Iterable[Dict[str, float]]) -> Schedule:
    boundaries, schedules, step = [], [], 0
    for kwargs in cosine_kwargs:
        schedules.append(warmup_cosine_decay_schedule(**kwargs))
        boundaries.append(step + kwargs["decay_steps"])
        step += kwargs["decay_steps"]
    return join_schedules(schedules, boundaries[:-1])


def linear_onecycle_schedule(transition_steps: int, peak_value: float, pct_start: float = 0.3,
                             pct_final: float = 0.85, div_factor: float = 25.0,
                             final_div_factor: float = 1e4) -> Schedule:
    if transition_steps <= 0:
        raise ValueError("A linear onecycle schedule was set with a non-positive "
                         "`transition_steps`")
    return piecewise_interpolate_schedule("linear", peak_value / div_factor, {
        int(pct_start * transition_steps): div_factor,
        int(pct_final * transition_steps): 1.0 / div_factor,
        transition_steps: 1.0 / final_div_factor,
    })


def cosine_onecycle_schedule(transition_steps: int, peak_value: float, pct_start: float = 0.3,
                             div_factor: float = 25.0, final_div_factor: float = 1e4
                             ) -> Schedule:
    if transition_steps <= 0:
        raise ValueError("A linear onecycle schedule was set with a non-positive "
                         "`transition_steps`")
    return piecewise_interpolate_schedule("cosine", peak_value / div_factor, {
        int(pct_start * transition_steps): div_factor,
        int(transition_steps): 1.0 / (div_factor * final_div_factor),
    })


__all__ = ["Schedule", "constant_schedule", "cosine_decay_schedule",
           "cosine_onecycle_schedule", "exponential_decay", "join_schedules",
           "linear_onecycle_schedule", "linear_schedule", "piecewise_constant_schedule",
           "piecewise_interpolate_schedule", "polynomial_schedule", "sgdr_schedule",
           "warmup_constant_schedule", "warmup_cosine_decay_schedule",
           "warmup_exponential_decay_schedule"]
