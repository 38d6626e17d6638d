"""The port's tracer: spans of the training loop's host stages and of the
train step's stages on the device, on one clock.

A :class:`Tracer` belongs to a ``Trainer`` and is off until
``Trainer.set_tracing(True)``.

**Host spans** (:meth:`Tracer.span`): ``wait`` (the loop's wait for a
prepared group), ``presort`` and ``pack`` (a group's preparation, in a
worker or on the loop's thread), ``place`` (an eager step's copy) and
``step`` (a dispatch's enqueue: the K-step graph's copy and replay, or an
eager step).  Each adds its duration to :attr:`Tracer.host_ms`, on or off.
With tracing on it is also kept, in a bounded ring that counts what it
drops.  Whenever a ``torch.profiler`` is recording, on or off, it is also a
``record_function`` range named ``torecsys.<stage>``, so the profiler's
trace names the program's stages.

**Device spans** come from marks (:func:`mark`) at the train step's stage
edges (``train.steps``, ``inputs.embeddings``) and around the K-step
dispatch's copy of its group.  With tracing on, a mark launches the stamp
kernel (``ops.kernels.trace``), which writes the card's clock into a slot of
a static ``(K, len(MARKS))`` buffer: a row a step.  The K-step CUDA graph
captures the launches, so each replay stamps again.  After each dispatch the
buffer's rows are copied, on the card and in stream order, into a ring of
:data:`RING_DISPATCHES` dispatches; nothing is read back until the spans are
read.  With tracing off a mark does nothing, and a graph captured then has
no stamp in it.  The spans (:data:`DEVICE_SPANS`): ``step``, and inside it
``forward`` (the model and the loss, with ``lookup`` inside it: from the
step's first table lookup to its last; inside it ``pool``, a multi-hot
input's pooled gather, and ``exchange``, the psum's collective over the
table group), ``backward``, ``dense_optimizer`` and
``sparse_update`` (the sparse route's sort, dedup, segment sums, row update
and every small op between them); and ``copy_in``, once a dispatch, the
group's copy to the card ahead of the graph's replay.

**Counters** (:func:`count`, :func:`count_device`), with tracing on: of a
step, a multi-hot input's ``ids`` and ``bags``, the bytes this rank hands
the mesh's collectives (``collective_bytes``) and the stored rows of a
table that this rank's sparse update touches (``touched_rows``, a device
count that the captured graph adds up on the card).  A host count taken
while the K-step graph is captured is kept by the graph
(:func:`recording`) and added again at each replay (:func:`replayed`), so
the counts are per dispatch, replays included.  :meth:`Tracer.report`
gives each a step.

**One clock.**  Host spans are read off ``time.perf_counter_ns``.  When
tracing is switched on and when the spans are read, the tracer stamps the
idle card :data:`CALIBRATION_ROUNDS` times, each between a host reading
just before the launch and one as soon as a poll finds it done, and keeps
the narrowest pair: the card's clock lies at their midpoint, within half
their distance.  Device stamps are mapped
onto the host clock by the offset interpolated between the two
calibrations, so each device span and each idle gap between dispatches
sits beside the host spans.  On the CPU the marks read the host clock
itself.

Reading drains: :meth:`Tracer.drain` returns the :class:`Span` records kept
since the last read, and :meth:`Tracer.report` reduces them
(:func:`reduce`): each device span's self time a step, the card's idle
between dispatches a step and the host stage that overlapped it.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import threading
import time
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torecsys_tpu_torch.ops.kernels import trace as stamp_kernel

HOST_STAGES = ("presort", "pack", "wait", "place", "step")
# the device marks, a row of them a step; the copy-in's pair is written in a
# dispatch's first row only
MARKS = ("copy_in.begin", "copy_in.end", "step.begin", "lookup.begin", "lookup.end",
         "forward.end", "backward.end", "dense_optimizer.end", "sparse_update.end", "step.end",
         "pool.begin", "pool.end", "exchange.begin", "exchange.end")
_COLUMN = {name: i for i, name in enumerate(MARKS)}
# each device span: (the mark it starts at, the mark it ends at, its parent)
DEVICE_SPANS = {
    "copy_in": ("copy_in.begin", "copy_in.end", None),
    "step": ("step.begin", "step.end", None),
    "forward": ("step.begin", "forward.end", "step"),
    "lookup": ("lookup.begin", "lookup.end", "forward"),
    "pool": ("pool.begin", "pool.end", "lookup"),
    "exchange": ("exchange.begin", "exchange.end", "lookup"),
    "backward": ("forward.end", "backward.end", "step"),
    "dense_optimizer": ("backward.end", "dense_optimizer.end", "step"),
    "sparse_update": ("dense_optimizer.end", "sparse_update.end", "step"),
}
HOST_COUNTERS = ("ids", "bags", "collective_bytes")
DEVICE_COUNTERS = ("touched_rows",)
RING_DISPATCHES = 4096           # dispatches the device ring keeps unread
HOST_SPANS_PER_DISPATCH = 16     # the host ring keeps this many a dispatch
CALIBRATION_ROUNDS = 20
PROFILER_PREFIX = "torecsys."
_UNSET = -1

_state = threading.local()


@dataclasses.dataclass(frozen=True)
class Span:
    """One span: its ``name``, ``start_ns`` and ``end_ns`` on the host's
    ``perf_counter_ns`` clock, the ``id`` of its ``parent`` span (None at the
    top), the ``dispatch`` it belongs to and its ``step`` (a device span's
    own step; a host span's and ``copy_in``'s, the dispatch's first), whether
    it ran on the ``device``, and the host ``thread`` that ran it (a device
    span's: the thread that dispatched it)."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    dispatch: int
    step: int
    device: bool
    thread: int


def mark(name: str) -> None:
    """Stamp the device mark ``name`` (of :data:`MARKS`) into the current
    step's row, where a tracing tracer is active on this thread
    (:meth:`Tracer.active`); else nothing.  A ``.begin`` mark keeps its
    step's first stamp, an ``.end`` mark its last."""
    tracer = getattr(_state, "tracer", None)
    if tracer is not None:
        tracer._stamp(name)


def count(name: str, n: int) -> None:
    """Add ``n`` to the host counter ``name`` (of :data:`HOST_COUNTERS`) of
    the current dispatch, where a tracing tracer is active on this thread;
    else nothing."""
    tracer = getattr(_state, "tracer", None)
    if tracer is not None:
        target = tracer._recording if tracer._recording is not None else tracer._pending
        target[name] += n


def count_device(name: str, t: torch.Tensor) -> None:
    """Add the 0-d integer device tensor ``t`` to the device counter
    ``name`` (of :data:`DEVICE_COUNTERS`) on the card, in stream order (a
    captured graph adds it at each replay), where a tracing tracer is active
    on this thread; else nothing."""
    tracer = getattr(_state, "tracer", None)
    if tracer is not None:
        tracer._device_counts[DEVICE_COUNTERS.index(name)].add_(t.reshape(()))


@contextlib.contextmanager
def recording() -> Iterator[collections.Counter]:
    """Inside the block (a graph's capture) the host counts go to the
    yielded counter, which the graph keeps, not to the dispatch."""
    tracer = getattr(_state, "tracer", None)
    counted: collections.Counter = collections.Counter()
    if tracer is None:
        yield counted
        return
    tracer._recording = counted
    try:
        yield counted
    finally:
        tracer._recording = None


def replayed(counted: collections.Counter) -> None:
    """Add a captured graph's host counts (:func:`recording`) to the current
    dispatch, at its replay."""
    tracer = getattr(_state, "tracer", None)
    if tracer is not None:
        tracer._pending.update(counted)


def start_row(row: int) -> None:
    """The marks that follow are step ``row`` of the dispatch (where a
    tracing tracer is active on this thread)."""
    tracer = getattr(_state, "tracer", None)
    if tracer is not None:
        tracer._row, tracer._begun = row, set()


class _HostSpan:
    """The context of one host span (:meth:`Tracer.span`)."""

    __slots__ = ("tracer", "name", "at", "id", "parent", "start", "profiled")

    def __init__(self, tracer: "Tracer", name: str, at: Optional[Tuple[int, int]]):
        self.tracer, self.name, self.at = tracer, name, at
        self.id = self.profiled = None

    def __enter__(self) -> "_HostSpan":
        tracer = self.tracer
        if torch._C._autograd._profiler_enabled():
            self.profiled = torch.autograd.profiler.record_function(PROFILER_PREFIX + self.name)
            self.profiled.__enter__()
        if tracer.enabled:
            stack = tracer._open_spans()
            self.parent = stack[-1] if stack else None
            self.id = tracer._next_id()
            stack.append(self.id)
            if self.at is None:
                self.at = (tracer.dispatches, tracer.steps)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        tracer = self.tracer
        with tracer._lock:
            tracer.host_ms[self.name] += (end - self.start) / 1e6
            if self.id is not None:
                if len(tracer._host) == tracer._host.maxlen:
                    tracer.dropped["host"] += 1
                tracer._host.append(Span(self.id, self.name, self.start, end, self.parent,
                                         self.at[0], self.at[1], False, threading.get_ident()))
        if self.id is not None:
            tracer._open_spans().pop()
        if self.profiled is not None:
            self.profiled.__exit__(None, None, None)


class Tracer:
    """The spans of one trainer's training loop (see the module's
    docstring).  ``device`` is where its steps run; ``capacity`` the
    dispatches its rings keep unread (the host ring
    :data:`HOST_SPANS_PER_DISPATCH` times as many spans)."""

    def __init__(self, device: torch.device, capacity: int = RING_DISPATCHES):
        self.device = torch.device(device)
        self.capacity = capacity
        self.enabled = False
        # host ms by stage, summed, on or off
        self.host_ms: Dict[str, float] = dict.fromkeys(HOST_STAGES, 0.0)
        self.dispatches = 0  # dispatches and steps so far, on or off
        self.steps = 0
        self.dropped = {"host": 0, "device": 0}
        self.uncertainty_us: Optional[float] = None  # of the last read's clock mapping
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = 0
        self._host: collections.deque = collections.deque(
            maxlen=capacity * HOST_SPANS_PER_DISPATCH)
        # (dispatch, first step, steps, ring slot, copy_in stamped, thread)
        self._meta: collections.deque = collections.deque(maxlen=capacity)
        self._flushed = 0
        self._buf: Optional[torch.Tensor] = None
        self._ring: Optional[torch.Tensor] = None
        self._calibration: Optional[Tuple[int, int, int]] = None
        self._row = 0
        self._begun: set = set()
        self._copied = False
        # the counters: the current dispatch's host counts, a capture's, and
        # the sums since the last report, with the steps they cover
        self._pending: collections.Counter = collections.Counter()
        self._recording: Optional[collections.Counter] = None
        self._counts: collections.Counter = collections.Counter()
        self._counted_steps = 0
        self._device_counts: Optional[torch.Tensor] = None

    # ---- switching -----------------------------------------------------

    def enable(self, k: int) -> None:
        """Record spans from now on, for dispatches of up to ``k`` steps:
        allocate the stamp buffer and the ring, and calibrate the clock
        (which builds the stamp kernel at its first use)."""
        marks = len(MARKS)
        self._buf = torch.full((k, marks), _UNSET, dtype=torch.int64, device=self.device)
        self._ring = torch.full((self.capacity, k, marks), _UNSET, dtype=torch.int64,
                                device=self.device)
        self._meta.clear()
        self._flushed = 0
        self._pending.clear()
        self._counts.clear()
        self._counted_steps = 0
        self._device_counts = torch.zeros(len(DEVICE_COUNTERS), dtype=torch.int64,
                                          device=self.device)
        self._calibration = self._calibrate()
        self.enabled = True

    def disable(self) -> None:
        """Record no more spans; those kept stay until they are read."""
        self.enabled = False

    @contextlib.contextmanager
    def active(self) -> Iterator[None]:
        """Where tracing is on, route the :func:`mark` and
        :func:`start_row` calls of this thread to this tracer inside the
        block (the trainer enters it around each dispatch)."""
        if not self.enabled:
            yield
            return
        prev = getattr(_state, "tracer", None)
        _state.tracer = self
        try:
            yield
        finally:
            _state.tracer = prev

    # ---- host spans and dispatches ------------------------------------

    def span(self, name: str, at: Optional[Tuple[int, int]] = None) -> _HostSpan:
        """A host span ``name`` around a ``with`` block.  ``at`` is its
        ``(dispatch, first step)`` where it is not the next dispatch's (a
        group prepared ahead in a worker, :meth:`numbered`)."""
        return _HostSpan(self, name, at)

    def numbered(self, groups: Iterable) -> Iterator:
        """Each group of ``groups`` with the ``(dispatch, first step)`` it
        will be dispatched as, the groups being dispatched in order from
        now."""
        dispatch, step = self.dispatches, self.steps
        for group in groups:
            yield group, (dispatch, step)
            dispatch += 1
            step += len(group)

    def begin_dispatch(self) -> None:
        """A dispatch starts: its marks go to row 0 until :func:`start_row`."""
        if self.enabled:
            self._row, self._begun, self._copied = 0, set(), False

    def end_dispatch(self, steps: int) -> None:
        """A dispatch of ``steps`` steps has been enqueued: with tracing on,
        enqueue the copy of its stamps into the ring (no synchronisation)."""
        if self.enabled:
            slot = self._flushed % self.capacity
            if len(self._meta) == self.capacity:
                self.dropped["device"] += 1
            self._ring[slot, :steps].copy_(self._buf[:steps], non_blocking=True)
            self._meta.append((self.dispatches, self.steps, steps, slot, self._copied,
                               threading.get_ident()))
            self._flushed += 1
            self._counts.update(self._pending)
            self._counted_steps += steps
        self._pending.clear()
        self.dispatches += 1
        self.steps += steps

    def _stamp(self, name: str) -> None:
        column = _COLUMN[name]
        if name.endswith(".begin"):
            if column in self._begun:
                return
            self._begun.add(column)
        if name == "copy_in.begin":
            self._copied = True
        stamp_kernel.stamp(self._buf, self._row * len(MARKS) + column)

    def _open_spans(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _next_id(self) -> int:
        with self._lock:
            self._ids += 1
            return self._ids

    # ---- the clock -----------------------------------------------------

    def _calibrate(self) -> Tuple[int, int, int]:
        """``(device ns, host ns, half width ns)``: the narrowest of
        :data:`CALIBRATION_ROUNDS` stamps, each between two host readings
        (``ops.kernels.trace.bracketed``), its host time their midpoint."""
        if self.device.type != "cuda":
            now = time.perf_counter_ns()
            return now, now, 0
        slots = torch.full((CALIBRATION_ROUNDS,), _UNSET, dtype=torch.int64, device=self.device)
        bounds = stamp_kernel.bracketed(slots)
        stamps = slots.tolist()
        i = min(range(CALIBRATION_ROUNDS), key=lambda j: bounds[j][1] - bounds[j][0])
        h0, h1 = bounds[i]
        return stamps[i], (h0 + h1) // 2, (h1 - h0) // 2

    # ---- reading -------------------------------------------------------

    def drain(self) -> List[Span]:
        """The spans kept since the last read, sorted by start, and forget
        them.  Reads the device ring (one synchronisation) and calibrates the
        clock again: this read's end is the next one's start."""
        with self._lock:
            spans = list(self._host)
            self._host.clear()
        meta = list(self._meta)
        self._meta.clear()
        if meta:
            start, end = self._calibration, self._calibrate()
            self._calibration = end
            self.uncertainty_us = max(start[2], end[2]) / 1e3
            spans += self._device_spans(meta, self._ring.cpu().numpy(), start, end)
        return sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))

    def _device_spans(self, meta, ring: np.ndarray, start, end) -> List[Span]:
        (d0, h0, _), (d1, h1, _) = start, end
        off0, off1 = d0 - h0, d1 - h1
        slope = (off1 - off0) / (d1 - d0) if d1 != d0 else 0.0

        def host_ns(d: int) -> int:
            return int(d - off0 - slope * (d - d0))

        spans = []
        for dispatch, first, steps, slot, copied, thread in meta:
            rows = ring[slot, :steps]
            for r in range(steps):
                ids: Dict[str, int] = {}
                for name, (begin, stop, parent) in DEVICE_SPANS.items():
                    if name == "copy_in" and (r > 0 or not copied):
                        continue
                    a, b = int(rows[r, _COLUMN[begin]]), int(rows[r, _COLUMN[stop]])
                    if a == _UNSET or b == _UNSET:
                        continue
                    ids[name] = self._next_id()
                    spans.append(Span(ids[name], name, host_ns(a), host_ns(b), ids.get(parent),
                                      dispatch, first if name == "copy_in" else first + r, True,
                                      thread))
        return spans

    def counts(self) -> Dict[str, float]:
        """Each counter a step (:data:`HOST_COUNTERS`, :data:`DEVICE_COUNTERS`)
        since tracing was switched on or the counts last read, and forget
        them; reading the device counters synchronises with the card."""
        steps = self._counted_steps
        out = {name: self._counts[name] / steps if steps else 0.0 for name in HOST_COUNTERS}
        if self._device_counts is not None:
            values = self._device_counts.tolist()
            self._device_counts.zero_()
            out.update({name: v / steps if steps else 0.0
                        for name, v in zip(DEVICE_COUNTERS, values)})
        self._counts.clear()
        self._counted_steps = 0
        return out

    def report(self) -> Dict:
        """:func:`reduce` of :meth:`drain`, with the read's clock
        uncertainty, the rings' drops and the counters a step
        (:meth:`counts`) since the last report."""
        out = reduce(self.drain())
        out["uncertainty_us"] = self.uncertainty_us
        out["dropped"] = dict(self.dropped)
        self.dropped = dict.fromkeys(self.dropped, 0)
        out["counts"] = self.counts()
        return out


def reduce(spans: Sequence[Span]) -> Dict:
    """What the ``spans`` of a read say a step, in ms:

    * ``steps`` and ``dispatches``: those whose device spans were read;
    * ``span_ms``: each device span's self time (its duration minus its
      children's);
    * ``other_ms``: the card's time inside the dispatches' extents (first
      mark to last) outside ``step`` and ``copy_in``;
    * ``gap_ms``: the card's idle between consecutive dispatches, from the
      last mark of one to the first of the next (its ``copy_in``);
    * ``gap_by_host``: that idle split by the top-level host span of the
      dispatching thread that overlapped it (``wait``, ``place``, ``step``),
      ``other`` where none did;
    * ``wall_ms``: from the first dispatch's first mark to the last one's
      last mark (``sum(span_ms) + other_ms + gap_ms`` where no dispatch was
      dropped between).
    """
    device = [s for s in spans if s.device]
    steps = len({s.step for s in device if s.name == "step"})
    by_dispatch: Dict[int, List[Span]] = collections.defaultdict(list)
    for s in device:
        by_dispatch[s.dispatch].append(s)
    out = {"steps": steps, "dispatches": len(by_dispatch), "span_ms": {}, "other_ms": 0.0,
           "gap_ms": 0.0, "gap_by_host": {"wait": 0.0, "place": 0.0, "step": 0.0, "other": 0.0},
           "wall_ms": 0.0}
    if not steps:
        return out
    per_step = 1e6 * steps
    children: Dict[int, int] = collections.defaultdict(int)
    for s in device:
        if s.parent is not None:
            children[s.parent] += s.end_ns - s.start_ns
    self_ns: Dict[str, int] = collections.defaultdict(int)
    for s in device:
        self_ns[s.name] += s.end_ns - s.start_ns - children[s.id]
    out["span_ms"] = {name: self_ns[name] / per_step for name in DEVICE_SPANS if name in self_ns}
    extents = {d: (min(s.start_ns for s in ss), max(s.end_ns for s in ss))
               for d, ss in by_dispatch.items()}
    roots = sum(s.end_ns - s.start_ns for s in device if s.parent is None)
    out["other_ms"] = (sum(b - a for a, b in extents.values()) - roots) / per_step
    thread = device[0].thread
    loop = sorted((s for s in spans if not s.device and s.parent is None and s.thread == thread),
                  key=lambda s: s.start_ns)
    starts = [s.start_ns for s in loop]
    gap_by_host = out["gap_by_host"]
    for d in sorted(extents):
        if d + 1 not in extents:
            continue
        a, b = extents[d][1], extents[d + 1][0]
        if b <= a:
            continue
        out["gap_ms"] += (b - a) / per_step
        covered = 0
        for s in loop[max(bisect.bisect_right(starts, a) - 1, 0):]:
            if s.start_ns >= b:
                break
            overlap = min(s.end_ns, b) - max(s.start_ns, a)
            if overlap > 0:
                gap_by_host[s.name] = gap_by_host.get(s.name, 0.0) + overlap / per_step
                covered += overlap
        gap_by_host["other"] += (b - a - covered) / per_step
    first, last = min(extents), max(extents)
    out["wall_ms"] = (extents[last][1] - extents[first][0]) / per_step
    return out


__all__ = ["CALIBRATION_ROUNDS", "DEVICE_COUNTERS", "DEVICE_SPANS", "HOST_COUNTERS",
           "HOST_STAGES", "MARKS", "RING_DISPATCHES", "Span", "Tracer", "count", "count_device",
           "mark", "recording", "reduce", "replayed", "start_row"]
