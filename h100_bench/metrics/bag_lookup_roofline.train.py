"""``bag_lookup_roofline.train``: the pooled gather's share of its roofline on
rank 0, in %: the bytes it needs a step (the configuration's
``bytes_per_step``: the int64 ids read, each distinct row of the rank's
quarter read once, the ``(B, N, E)`` bag sums written) at the HBM rate, over
the device time a step of the kernels whose name holds
``pooled_row_gather``.  None where no such kernel ran (a program without
it)."""

from harness.card import bound_s

KERNEL = "pooled_row_gather"


def read(seg):
    seconds = sum(b - a for name, a, b in seg.device.ops if KERNEL in name) / 1e6
    if seconds <= 0 or seg.steps == 0 or "bag_lookup" not in seg.bytes:
        return None
    return 100.0 * bound_s(seg.bytes["bag_lookup"]) / (seconds / seg.steps)
