"""``sparse_update_roofline.train``: the sparse update's share of its
roofline, in %: the bytes it needs a step
(``harness.counts.sparse_update_bytes``) at the HBM rate, over the device
time a step of its kernels (sort, dedup, segment sums, row update;
``harness.layers``)."""

from harness.card import bound_s
from harness.layers import layer_seconds


def read(seg):
    seconds = layer_seconds(seg.device, "sparse_update")
    if seconds <= 0 or seg.steps == 0:
        return None
    return 100.0 * bound_s(seg.bytes["sparse_update"]) / (seconds / seg.steps)
