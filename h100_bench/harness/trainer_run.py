"""A training cell driven through the program's ``Trainer.train_steps``.

A configuration's module returns a :class:`TrainerRun` from its
``make_run`` hook and gives it, as module attributes, what belongs to the
configuration: ``build_program``, ``weight_spec``, ``load_weights``,
``program_grad_norms``, ``program_change_norms``, ``batch_stats``,
``ops_per_step``, ``bytes_per_step`` and the reference's
``reference_train`` (with the ``reference_inputs``, ``forward`` and
``penalty`` it calls).

Set-up builds one ``Trainer``, writes the benchmark's weights (made from
the seed, ``harness.weights``) into it, seeds torch's generators for the
dropout masks, and hands it the pool's first :data:`COMPARED_GROUPS` groups
of K batches in one ``train_steps`` call: the window's own call, feed and
K-step dispatch.  The first group runs its K steps (eagerly, on the stream
it then captures them on) and captures them as a CUDA graph; the second
replays the graph.  The comparison's readings are taken off the program's
state: the gradient norms after the first step (:class:`FirstStep`), the
changes after the last; the reference follows the same steps after the
window.  Further groups warm it up.  The window (:meth:`TrainerRun.window`) hands the same trainer one
``train_steps`` call over the pool, cycled, until the host clock passes its
length at a group's end; a traced segment (:meth:`TrainerRun.traced`) does
the same under the profiler.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from harness import weights
from harness.profiling import MarkLost, TraceWindow

COMPARED_GROUPS = 2
WARM_GROUPS = 1
TRACE_SECONDS = 1.0
TRACE_ATTEMPTS = 3


def stamp(cuda: bool):
    """A CUDA event recorded on the current stream (the host clock on the
    CPU)."""
    if not cuda:
        return time.perf_counter()
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def elapsed_ms(a, b, cuda: bool) -> float:
    return a.elapsed_time(b) if cuda else (b - a) * 1e3


class DispatchStamps:
    """While entered, a stamp after each of the trainer's dispatches, taken
    on the loop's thread as the dispatch returns: a hook over the trainer's
    ``_dispatch``, whose return follows the enqueue of the group's copy and
    graph replay (or eager steps)."""

    def __init__(self, trainer, cuda: bool):
        if not callable(getattr(trainer, "_dispatch", None)):
            raise RuntimeError("the program's Trainer has no _dispatch to stamp")
        self.trainer, self.cuda = trainer, cuda
        self.stamps: List = []

    def __enter__(self) -> "DispatchStamps":
        original = self.trainer._dispatch

        def dispatch(group):
            losses = original(group)
            self.stamps.append(stamp(self.cuda))
            return losses

        self.trainer._dispatch = dispatch
        return self

    def __exit__(self, *exc) -> None:
        del self.trainer._dispatch


class FirstStep:
    """While entered, ``read()`` once, right after the trainer's first train
    step returns: a hook over the trainer's ``_train_step_fn``, the step
    that its K-step dispatch runs K times a group and captures.  The first
    group runs it eagerly before the capture, so the reading (a host read
    that waits for the card) falls between its first and second steps; the
    captured graph, and every later call, see the step alone."""

    def __init__(self, trainer, read: Callable):
        if not callable(getattr(trainer, "_train_step_fn", None)):
            raise RuntimeError("the program's Trainer has no _train_step_fn to read after")
        self.trainer, self.read = trainer, read
        self.readings = None

    def __enter__(self) -> "FirstStep":
        self.original = original = self.trainer._train_step_fn

        def step(state, batch):
            out = original(state, batch)
            if self.readings is None:
                self.readings = self.read()
            return out

        self.trainer._train_step_fn = step
        return self

    def __exit__(self, *exc) -> None:
        self.trainer._train_step_fn = self.original


class Feed:
    """The pool cycled from ``start``, in whole groups of ``k``, until the
    host clock passes ``deadline`` at a group's first batch;
    ``on_group(g)`` runs before group ``g``'s first batch."""

    def __init__(self, pool, start: int, k: int):
        self.pool, self.start, self.k = pool, start, k
        self.deadline: Optional[float] = None
        self.on_group: Optional[Callable] = None
        self.pulled = 0

    def indices(self) -> List[int]:
        return [(self.start + i) % len(self.pool) for i in range(self.pulled)]

    def __iter__(self):
        while True:
            if self.pulled % self.k == 0:
                if self.on_group is not None:
                    self.on_group(self.pulled // self.k)
                if self.deadline is not None and time.perf_counter() >= self.deadline:
                    return
            yield self.pool[(self.start + self.pulled) % len(self.pool)]
            self.pulled += 1


def _failed(losses) -> int:
    import torch

    return len(losses) - int(torch.isfinite(torch.stack(losses)).sum().item())


class TrainerRun:
    """One run of a training cell (see the module's docstring)."""

    def __init__(self, cell, device, seed: int):
        self.cell, self.cfg, self.model, self.mix = cell, cell.config, cell.model, cell.mix
        self.device, self.seed = device, seed
        self.k = self.cfg["steps_per_execution"]
        self.params, self.buffers = self.model.weight_spec(self.cfg)
        self.table_names = [n for n, (_, init) in self.params.items() if init[0] == "table"]
        self.rng_seed = weights.stream_seed(seed, 2)
        self.trainer = None
        self.pool: List = []
        self.next_index = 0
        self.readings: Dict = {}
        self._stats: Dict[int, Dict[str, int]] = {}

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    @property
    def compared(self) -> int:
        """The steps compared: the first :data:`COMPARED_GROUPS` groups."""
        return COMPARED_GROUPS * self.k

    def _sync(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.synchronize()

    def setup(self, warm: bool = True) -> None:
        """Everything before the window (see the module's docstring);
        without ``warm`` it stops after the compared steps' readings."""
        import torch

        from harness.card import log

        cfg, clock, model = self.cfg, time.perf_counter, self.model
        t0 = clock()
        self.pool = self.cell.generator.make_pool(self.mix, cfg, self.seed)
        if len(self.pool) < self.compared + self.k:
            raise ValueError("the pool must hold the compared steps' batches and one group")
        t1 = clock()
        self.trainer = model.build_program(cfg, self.device, self.seed)
        self._sync()
        tb = clock()
        model.load_weights(self.trainer, self.params, self.buffers, self.seed, self.device)
        self._sync()
        t2 = clock()
        torch.manual_seed(self.rng_seed)
        with FirstStep(self.trainer, lambda: model.program_grad_norms(
                self.trainer, self.params, cfg)) as first:
            losses = [float(x) for x in self.trainer.train_steps(self.pool[:self.compared])]
        graphs = self.trainer.graph_stats
        if self.cuda and graphs != {"captures": 1, "replays": COMPARED_GROUPS - 1}:
            raise RuntimeError(f"the compared steps ran as {graphs}, not one capture and "
                               f"{COMPARED_GROUPS - 1} replay(s) of the K-step graph")
        self.readings = {"losses": losses, "grad_norms": first.readings,
                         "change_norms": model.program_change_norms(
                             self.trainer, self.params, self.seed, self.device)}
        self.next_index = self.compared
        t3 = clock()
        if warm:
            batches = [self.pool[(self.next_index + i) % len(self.pool)]
                       for i in range(WARM_GROUPS * self.k)]
            self.trainer.train_steps(batches)
            self.next_index += len(batches)
        self._sync()
        log(f"set-up s: traffic {t1 - t0:.3f}, trainer {tb - t1:.3f}, weights {t2 - tb:.3f}, "
            f"compared steps and readings {t3 - t2:.3f}, warm-up {clock() - t3:.3f}")

    def window(self, seconds: float) -> Dict:
        """The timed window: examples a second; the 95th percentile of the
        step time from the intervals between consecutive dispatches'
        completions (stamped by :class:`DispatchStamps`, the first from the
        window's start), over K; the host's ms a step by stage; the steps
        attempted and those whose loss was not finite."""
        trainer, k = self.trainer, self.k
        captures = trainer.graph_stats["captures"]
        host_before = dict(trainer.host_ms)
        feed = Feed(self.pool, self.next_index, k)
        self._sync()
        with DispatchStamps(trainer, self.cuda) as stamps:
            t0 = time.perf_counter()
            start = stamp(self.cuda)
            feed.deadline = t0 + seconds
            losses = trainer.train_steps(feed)
            float(losses[-1])
            t1 = time.perf_counter()
        self.next_index += feed.pulled
        if trainer.graph_stats["captures"] != captures:
            raise RuntimeError("the K-step graph was captured again inside the window")
        marks = [start, *stamps.stamps]
        per_step = [elapsed_ms(a, b, self.cuda) / k for a, b in zip(marks, marks[1:])]
        steps = len(losses)
        return {"seconds": t1 - t0, "steps": steps,
                "examples_per_s": steps * self.mix["batch_size"] / (t1 - t0),
                "step_p95_ms": float(np.percentile(per_step, 95)),
                "intervals": len(per_step), "failed": _failed(losses),
                "host_ms": {s: (trainer.host_ms[s] - host_before.get(s, 0.0)) / steps
                            for s in trainer.host_ms},
                "batches": feed.indices()}

    def stats(self, indices) -> Dict[str, float]:
        """The mean over the pool batches ``indices`` of the configuration's
        ``batch_stats``."""
        for i in set(indices):
            if i not in self._stats:
                self._stats[i] = self.model.batch_stats(self.cfg, self.pool[i])
        keys = self._stats[indices[0]]
        return {key: sum(self._stats[i][key] for i in indices) / len(indices) for key in keys}

    def traced(self, seconds: float = TRACE_SECONDS) -> Dict:
        """A traced segment: one ``train_steps`` call whose profiler window
        opens as the feed reaches its third group, before the second's
        dispatch, and closes at the first group's end past ``seconds``;
        taken again where the profiler lost the mark."""
        trainer, k = self.trainer, self.k
        for _ in range(TRACE_ATTEMPTS):
            tw = TraceWindow()
            at: Dict = {}
            feed = Feed(self.pool, self.next_index, k)

            def on_group(g, feed=feed, tw=tw, at=at):
                if g == 2:
                    tw.start()
                    at["count"] = trainer.state.loss_count
                    feed.deadline = time.perf_counter() + seconds

            feed.on_group = on_group
            losses = trainer.train_steps(feed)
            self.next_index += feed.pulled
            try:
                device = tw.stop()
            except MarkLost:
                continue
            steps = trainer.state.loss_count - at["count"]
            traced = feed.indices()[k:]
            if steps != len(traced):
                raise RuntimeError(f"{steps} steps traced, {len(traced)} batches fed")
            return {"device": device, "steps": steps, "batches": traced,
                    "failed": _failed(losses)}
        raise MarkLost(f"the profiler lost the mark in {TRACE_ATTEMPTS} traced segments")

    def free(self) -> None:
        """Hand the program's memory back to the card."""
        import torch

        self.trainer = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def reference(self, mode: str = "stated", fault=None) -> Dict:
        """The reference's readings over the compared steps, from the
        weights made again from the seed."""
        import torch

        from reference.precision import no_tf32

        no_tf32()
        spec = {**self.params, **self.buffers}
        made = weights.make(spec, self.seed, self.device)
        params = {n: made[n] for n in self.params}
        buffers = {n: made[n] for n in self.buffers}
        del made
        initial = {name: weights.initial_blocks(self.params, name, self.seed, self.device)
                   for name in self.table_names}
        out = self.model.reference_train(self.model, params, buffers, self.table_names,
                                         self.pool[:self.compared], self.cfg, mode, initial,
                                         self.rng_seed, fault)
        del params, buffers
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()
        return out


__all__ = ["COMPARED_GROUPS", "DispatchStamps", "Feed", "FirstStep", "TrainerRun"]
