"""``device_busy_untraced.train``: the card's busy share of the untraced
window, in %: the traced segment's busy seconds a step (the union of its
kernel and copy intervals, over its steps) over the untraced window's
seconds a step.  Beside ``device_idle.train``, which the profiler's slowing
of the host raises, it says how far the host holds the card back when
nothing traces it; the profiler's own cost on each kernel can carry it a
little past 100."""


def read(seg):
    if seg.steps == 0 or seg.step_s <= 0 or seg.device.busy_s <= 0:
        return None
    return 100.0 * seg.device.busy_s / seg.steps / seg.step_s
