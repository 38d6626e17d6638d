"""``dense_ms.train``: device ms a step of every kernel that belongs neither
to the lookup nor to the sparse update and is not a copy: the model, the
loss and the dense optimizer (``harness.layers``)."""

from harness.layers import layer_seconds


def read(seg):
    seconds = layer_seconds(seg.device, "dense")
    return None if seconds <= 0 or seg.steps == 0 else seconds / seg.steps * 1e3
