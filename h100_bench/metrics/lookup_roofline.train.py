"""``lookup_roofline.train``: the lookup's share of its roofline, in %: the
bytes the lookup needs a step (``harness.counts.lookup_bytes``) at the HBM
rate, over the device time of the lookup's kernels a step (the forward row
gather and the gradients' permute, ``harness.layers``)."""

from harness.card import bound_s
from harness.layers import layer_seconds


def read(seg):
    seconds = layer_seconds(seg.device, "lookup")
    if seconds <= 0 or seg.steps == 0:
        return None
    return 100.0 * bound_s(seg.bytes["lookup"]) / (seconds / seg.steps)
