"""A training cell on a mesh of cards, one process a card, driven through
the program's ``Trainer.train_steps``.

:class:`MeshRun` keeps :class:`~harness.trainer_run.TrainerRun`'s interface
(``setup``, ``window``, ``traced``, ``stats``, ``free``, ``reference``,
``readings``), so ``run.py`` and ``calibrate.py`` take it as they take a
one-card run.  A configuration's ``make_run`` returns it, and gives, beside
``TrainerRun``'s hooks, ``require_program`` (raises at once where the
program lacks what the configuration needs) and ``mesh`` in its JSON
(``data``, ``table``).

**Ranks.**  Rank 0 is the calling process (``run.py``'s) on ``cuda:0``.
:meth:`MeshRun.setup` starts ranks 1 to ``world - 1`` (``spawn``, never
``fork``), rank ``r`` on ``cuda:r`` with one torch thread, and brings the
process group up over ``tcp://127.0.0.1:<a free port>`` (NCCL; gloo for a
rehearsal on the CPU), with a gloo group beside it for the host's own
decisions.  ``run.py`` pins only its own process, to one core; each other
rank keeps to one core of its own, the ``r``-th before rank 0's, where the
machine lets it (its own affinity is all it changes).

**One program, every rank.**  Each rank builds its ``Trainer`` on the mesh
(the configuration's ``build_program``), writes its own rows of the seed's
weights (``load_weights``) and runs the same steps: the compared steps and
their readings, whose sharded leaves each hook reduces over the table
group, the warm-up, the window and the traced segments.  The window's feed
goes on or stops at each group's start as rank 0 decides, broadcast over
the gloo group (:class:`MeshFeed`), so every rank dispatches the same
groups.  Rank 0 alone is profiled and reports: its peak memory is the run's,
and each other rank's peak over set-up is logged.

**Failures.**  A rank that raises prints its traceback and exits non-zero;
rank 0 watches the others and, where one has failed, ends them all and
exits non-zero itself within seconds; a rank whose rank 0 is gone exits.
A hang inside a collective ends at the process group's timeout
(:data:`TIMEOUT_S`).  No process is left behind.

:meth:`MeshRun.free` ends ranks 1 and up and the process group, so a
``calibrate.py`` sets up again for each seed in one process.  The
reference runs on rank 0's card alone, after ``free``.
"""

from __future__ import annotations

import datetime
import gc
import os
import socket
import sys
import threading
import time
import traceback
from typing import Dict, Optional

import numpy as np

from harness import weights
from harness.profiling import MarkLost, TraceWindow
from harness.trainer_run import (COMPARED_GROUPS, DispatchStamps, Feed, TRACE_ATTEMPTS,
                                 TRACE_SECONDS, TrainerRun, _failed, elapsed_ms, stamp)

TIMEOUT_S = 90
JOIN_S = 60
WATCH_S = 0.5


def _log_leaves(side: str, readings: Dict) -> None:
    """Each leaf's readings of ``side`` to the log, every digit kept, so that
    a number over its limit can be traced to its leaf and its rounding."""
    from harness.card import log

    for key in ("grad_norms", "change_norms"):
        log(f"{side} {key}: " + ", ".join(f"{k} {v!r}" for k, v in readings.get(key, {}).items()))


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_group(rank: int, world: int, port: int, cuda: bool):
    """The default process group and a gloo group beside it."""
    import torch.distributed as dist

    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dist.new_group(backend="gloo")


class MeshFeed(Feed):
    """:class:`Feed` whose every rank takes the groups rank 0 takes: at each
    group's start rank 0's decision (its deadline) is broadcast over the
    gloo group ``group``."""

    def __init__(self, pool, start: int, k: int, group):
        super().__init__(pool, start, k)
        self.group = group

    def _go(self, local: bool) -> bool:
        import torch
        import torch.distributed as dist

        t = torch.tensor([int(local)], dtype=torch.int32)
        dist.broadcast(t, src=0, group=self.group)
        return bool(t.item())

    def __iter__(self):
        while True:
            if self.pulled % self.k == 0:
                if self.on_group is not None:
                    self.on_group(self.pulled // self.k)
                go = self.deadline is None or time.perf_counter() < self.deadline
                if not self._go(go):
                    return
            yield self.pool[(self.start + self.pulled) % len(self.pool)]
            self.pulled += 1


class RankRun(TrainerRun):
    """One rank's part of a :class:`MeshRun`: ``TrainerRun``'s set-up, and
    its window and traced segments over :class:`MeshFeed`."""

    def __init__(self, cell, device, seed: int, rank: int, group):
        super().__init__(cell, device, seed)
        self.rank, self.group = rank, group

    def window(self, seconds: float) -> Dict:
        """``TrainerRun.window`` over a :class:`MeshFeed`; rank 0's deadline
        decides."""
        trainer, k = self.trainer, self.k
        captures = trainer.graph_stats["captures"]
        host_before = dict(trainer.host_ms)
        feed = MeshFeed(self.pool, self.next_index, k, self.group)
        self._sync()
        with DispatchStamps(trainer, self.cuda) as stamps:
            t0 = time.perf_counter()
            start = stamp(self.cuda)
            feed.deadline = t0 + seconds if self.rank == 0 else None
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

    def traced_attempt(self, seconds: float) -> Optional[Dict]:
        """One segment of ``TrainerRun.traced``: on rank 0 under the
        profiler (None where the profiler lost the mark), on the others the
        same groups untraced."""
        trainer, k = self.trainer, self.k
        tw = TraceWindow() if self.rank == 0 else None
        at: Dict = {}
        feed = MeshFeed(self.pool, self.next_index, k, self.group)

        def on_group(g):
            if g == 2:
                if tw is not None:
                    tw.start()
                    feed.deadline = time.perf_counter() + seconds
                at["count"] = trainer.state.loss_count

        feed.on_group = on_group
        losses = trainer.train_steps(feed)
        self.next_index += feed.pulled
        if tw is None:
            self._sync()
            return None
        try:
            device = tw.stop()
        except MarkLost:
            return None
        steps = trainer.state.loss_count - at["count"]
        traced = feed.indices()[k:]
        if steps != len(traced):
            raise RuntimeError(f"{steps} steps traced, {len(traced)} batches fed")
        return {"device": device, "steps": steps, "batches": traced, "failed": _failed(losses)}

    def peak_gb(self) -> float:
        import torch

        return torch.cuda.max_memory_allocated(self.device) / 1e9 if self.cuda else 0.0


def _pin(core: Optional[int]) -> None:
    if core is None:
        return
    try:
        os.sched_setaffinity(0, {core})
    except OSError:
        pass  # the machine keeps this process where it was


def _watch_parent(parent: int) -> None:
    """End this rank where rank 0 is gone."""
    while True:
        if os.getppid() != parent:
            os._exit(1)
        time.sleep(WATCH_S)


def _rank_main(rank: int, world: int, port: int, cell_name: str, root: str, config: Dict,
               mix: Dict, seed: int, device_type: str, core: Optional[int], parent: int,
               conn) -> None:
    """Rank ``rank``'s process: build the run, then do what rank 0 sends
    (``setup``, ``window``, ``traced``, ``free``), answering each."""
    threading.Thread(target=_watch_parent, args=(parent,), daemon=True).start()
    _pin(core)
    try:
        import torch

        torch.set_num_threads(1)
        cuda = device_type == "cuda"
        device = torch.device("cuda", rank) if cuda else torch.device("cpu")
        if cuda:
            torch.cuda.set_device(device)
            torch.cuda.reset_peak_memory_stats(device)
        group = _start_group(rank, world, port, cuda)
        from harness import cell as cells

        cell = cells.load(cell_name, type(cells.ROOT)(root))
        cell.config, cell.mix = config, mix
        run = RankRun(cell, device, seed, rank, group)
        while True:
            cmd, arg = conn.recv()
            if cmd == "setup":
                run.setup(warm=arg)
                conn.send(("ok", run.peak_gb()))
            elif cmd == "window":
                run.window(arg)
                conn.send(("ok", None))
            elif cmd == "traced":
                run.traced_attempt(arg)
                conn.send(("ok", None))
            elif cmd == "free":
                run.free()
                import torch.distributed as dist

                dist.destroy_process_group()
                conn.send(("ok", None))
                return
            else:
                raise ValueError(f"unknown command {cmd!r}")
    except BaseException:  # noqa: BLE001 - any failure ends the whole mesh
        print(f"rank {rank} failed:\n{traceback.format_exc()}", file=sys.stderr, flush=True)
        os._exit(1)


class MeshRun:
    """One run of a training cell on a mesh of ``world`` cards (see the
    module's docstring)."""

    def __init__(self, cell, device, seed: int):
        self.cell, self.cfg, self.model, self.mix = cell, cell.config, cell.model, cell.mix
        self.device, self.seed = device, seed
        mesh = self.cfg["mesh"]
        self.world = mesh["data"] * mesh["table"]
        self.k = self.cfg["steps_per_execution"]
        self.params, self.buffers = self.model.weight_spec(self.cfg)
        self.table_names = [n for n, (_, init) in self.params.items() if init[0] == "table"]
        self.local: Optional[RankRun] = None
        self.pool = None  # rank 0's pool, the reference's batches
        self.procs, self.conns = [], []
        self.readings: Dict = {}
        self.peaks_gb: Dict[int, float] = {}
        self._closing = False

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    @property
    def compared(self) -> int:
        return COMPARED_GROUPS * self.k

    # ---- the ranks ---------------------------------------------------------

    def _fail(self, why: str) -> None:
        """End every rank and this process, non-zero."""
        from harness.card import log

        log(f"mesh run failed: {why}")
        for p in self.procs:
            if p.is_alive():
                p.kill()
        os._exit(1)

    def _watch(self) -> None:
        while not self._closing:
            for r, p in enumerate(self.procs, start=1):
                if p.exitcode not in (None, 0) and not self._closing:
                    self._fail(f"rank {r} exited with code {p.exitcode}")
            time.sleep(WATCH_S)

    def _all(self, cmd: str, arg, local):
        """Send ``cmd`` to ranks 1 and up, run ``local()`` here, then collect
        their answers; any failure ends the mesh."""
        for c in self.conns:
            c.send((cmd, arg))
        try:
            out = local()
        except BaseException:  # noqa: BLE001
            self._fail(f"rank 0 raised:\n{traceback.format_exc()}")
        answers = []
        for r, c in enumerate(self.conns, start=1):
            if not c.poll(JOIN_S + TIMEOUT_S):
                self._fail(f"rank {r} did not answer {cmd!r}")
            status, payload = c.recv()
            answers.append(payload)
        return out, answers

    def setup(self, warm: bool = True) -> None:
        """Start the ranks and the process group, then every rank's
        ``TrainerRun.setup``."""
        import multiprocessing as mp

        import torch

        from harness import cell as cells
        from harness.card import log

        self.model.require_program()
        port = free_port()
        ctx = mp.get_context("spawn")
        pinned = max(os.sched_getaffinity(0))
        root = str(cells.ROOT)
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
        self._closing = False
        for r in range(1, self.world):
            mine, theirs = ctx.Pipe()
            core = pinned - r if pinned - r >= 0 else None
            p = ctx.Process(target=_rank_main, daemon=True, args=(
                r, self.world, port, self.cell.name, root, self.cfg, self.mix, self.seed,
                self.device.type, core, os.getpid(), theirs))
            p.start()
            self.procs.append(p)
            self.conns.append(mine)
        threading.Thread(target=self._watch, daemon=True).start()
        try:
            group = _start_group(0, self.world, port, self.cuda)
        except BaseException:  # noqa: BLE001
            self._fail(f"rank 0 could not join the process group:\n{traceback.format_exc()}")
        self.local = RankRun(self.cell, self.device, self.seed, 0, group)
        _, peaks = self._all("setup", warm, lambda: self.local.setup(warm))
        self.peaks_gb = {0: self.local.peak_gb(), **dict(enumerate(peaks, start=1))}
        self.readings = self.local.readings
        self.pool = self.local.pool
        log(f"ranks' peak GB over set-up: {self.peaks_gb}")
        _log_leaves("program", self.readings)
        if self.cuda:
            torch.cuda.synchronize()

    def window(self, seconds: float) -> Dict:
        return self._all("window", seconds, lambda: self.local.window(seconds))[0]

    def traced(self, seconds: float = TRACE_SECONDS) -> Dict:
        for _ in range(TRACE_ATTEMPTS):
            out, _ = self._all("traced", seconds, lambda: self.local.traced_attempt(seconds))
            if out is not None:
                return out
        raise MarkLost(f"the profiler lost the mark in {TRACE_ATTEMPTS} traced segments")

    def stats(self, indices) -> Dict[str, float]:
        return self.local.stats(indices)

    def free(self) -> None:
        """End ranks 1 and up and the process group, and hand rank 0's
        memory back to the card."""
        import torch
        import torch.distributed as dist

        def local():
            self.local.free()
            dist.destroy_process_group()  # with the other ranks: NCCL ends its groups together

        self._all("free", None, local)
        self._closing = True
        for p in self.procs:
            p.join(JOIN_S)
            if p.is_alive():
                p.kill()
        self.procs, self.conns = [], []
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def reference(self, mode: str = "stated", fault=None) -> Dict:
        """The reference's readings over the compared steps, on rank 0's
        card alone: the dense weights and the touched rows of the table made
        again from the seed; the batches are the pool's (made from the seed
        where no set-up made it)."""
        import torch

        from reference.precision import no_tf32

        no_tf32()
        dense = weights.make(self.params, self.seed, self.device, with_tables=False)
        (name,) = self.table_names
        spec = self.params

        def initial_rows(ids: torch.Tensor) -> torch.Tensor:
            (rows, embed), (_, std) = spec[name]
            index = weights.tables(spec)[name]
            out = torch.empty((ids.shape[0], embed), dtype=torch.float32, device=ids.device)
            blocks = torch.div(ids, weights.TABLE_BLOCK_ROWS, rounding_mode="floor")
            for block in torch.unique(blocks).tolist():
                at = torch.nonzero(blocks == block).reshape(-1)
                t = weights.table_block(self.seed, index, block, rows, embed, std, ids.device)
                out[at] = t[ids[at] - block * weights.TABLE_BLOCK_ROWS]
                del t
            return out

        if self.pool is None:
            self.pool = self.cell.generator.make_pool(self.mix, self.cfg, self.seed)
        out = self.model.reference_train(dense, initial_rows, self.pool[:self.compared],
                                         self.cfg, mode, fault)
        if mode == "stated" and fault is None:
            _log_leaves("reference", out)
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()
        return out


__all__ = ["MeshFeed", "MeshRun", "RankRun", "free_port"]
