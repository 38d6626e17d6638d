"""The profiler window of a traced run and its reduction to device intervals.

``torch.profiler`` starts recording the card's events some milliseconds into
its window and now and then loses a prefix of them.  So a window starts with
a lead spin kernel that is waited for, then a short spin kernel, the mark;
only the events after the mark are read, and a window whose mark was not
recorded is refused (:class:`MarkLost`) and taken again by the caller.  (The
lead, the mark and the rule are those of the port's chip checks,
``chip_smoke.py`` ``card_profile`` and ``marked_events``, copied.)

Everything is computed from ``prof.events()`` in memory; nothing is written.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

LEAD_CYCLES = 100_000_000      # about 50 ms of the card's clock
MARK_CYCLES = LEAD_CYCLES // 10
MARK_MAX_US = 20_000           # the mark is shorter, the lead longer
BREAKDOWN_ENTRIES = 10
NAME_CHARS = 160
SHORT_GAP_US = 20.0            # gaps under it are the launch gaps between kernels


class MarkLost(RuntimeError):
    """The profiler lost the window's mark: events after it may be lost."""


@dataclass
class DeviceWindow:
    """The card's operations in a traced window, after its mark.

    ``ops`` are ``(name, start_us, end_us)`` of kernels, copies and memsets;
    ``gaps`` are ``(host activity, seconds)`` of each idle stretch, labelled
    by the host operation that overlapped it most."""

    ops: List[Tuple[str, float, float]]
    window_s: float
    busy_s: float
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def by_name(self) -> Dict[str, float]:
        """Device seconds by operation name."""
        out: Dict[str, float] = {}
        for name, a, b in self.ops:
            out[name] = out.get(name, 0.0) + (b - a) / 1e6
        return out

    def breakdown(self) -> Dict[str, List]:
        """The ``breakdown`` of a result line: the device operations that
        took most time, and the idle time by what the host was doing."""
        top = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
        idle: Dict[str, float] = {}
        for label, s in self.gaps:
            idle[label] = idle.get(label, 0.0) + s
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
        return {"device_ops": [[n[:NAME_CHARS], s] for n, s in top],
                "idle_gaps": [[n[:NAME_CHARS], s] for n, s in gaps]}


class TraceWindow:
    """A profiler window over part of a run: :meth:`start` (the lead, then
    the mark, enqueued behind it), the run's own work, then :meth:`stop`."""

    def __init__(self):
        self.prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda._sleep(LEAD_CYCLES)
        torch.cuda.synchronize()
        torch.cuda._sleep(MARK_CYCLES)

    def stop(self) -> DeviceWindow:
        """Wait for the card, close the window and reduce it; raises
        :class:`MarkLost` where the mark was not recorded."""
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self.prof.stop()
        events = self.prof.events()
        self.prof = None
        device, host = [], []
        for e in events:
            if getattr(e, "is_user_annotation", False):
                continue
            if e.device_type == DeviceType.CUDA:
                device.append(e)
            elif e.device_type == DeviceType.CPU and e.cpu_parent is None:
                host.append((e.time_range.start, e.time_range.end, e.name))
        spins = sorted((e.time_range for e in device if "spin_kernel" in e.name),
                       key=lambda r: r.start)
        if not spins or spins[-1].end - spins[-1].start > MARK_MAX_US:
            raise MarkLost("the profiler did not record the window's mark")
        mark_end = spins[-1].end
        ops = sorted(((e.name, float(e.time_range.start), float(e.time_range.end))
                      for e in device
                      if e.time_range.start >= mark_end and "spin_kernel" not in e.name
                      and not e.name.startswith(("Optimizer.", "ProfilerStep"))),
                     key=lambda op: op[1])
        if not ops:
            raise MarkLost("no device operation after the window's mark")
        end = max(b for _, _, b in ops)
        busy, gaps, reach = 0.0, [], float(mark_end)
        for _, a, b in ops:
            if a > reach:
                gaps.append((reach, a))
            if b > reach:
                busy += b - max(a, reach)
                reach = b
        labelled = [(_host_label(host, a, b) if b - a >= SHORT_GAP_US
                     else f"gaps under {SHORT_GAP_US:g} us between device operations",
                     (b - a) / 1e6) for a, b in gaps]
        return DeviceWindow(ops, (end - mark_end) / 1e6, busy / 1e6, labelled)


def _host_label(host, a: float, b: float) -> str:
    """The top-level host operation that overlaps ``[a, b]`` most."""
    best, name = 0.0, "host: no operation recorded"
    for s, e, n in host:
        overlap = min(e, b) - max(s, a)
        if overlap > best:
            best, name = overlap, n
    return name


__all__ = ["DeviceWindow", "MarkLost", "TraceWindow"]
