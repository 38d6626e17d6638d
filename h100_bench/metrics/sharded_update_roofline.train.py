"""``sharded_update_roofline.train``: the sparse update's share of its
roofline on rank 0, its quarter of the table, in %: the bytes it needs a
step (the configuration's ``bytes_per_step["sparse_update"]``: the ``(B, N,
E)`` bag gradients and the int32 ids read, each touched row of the rank's
table and of Adagrad's ``v`` read and written) at the HBM rate, over the
device time a step of the sparse update's kernels (sort, scan, scatter,
segment sums, row update; ``harness.layers``) and of the gradients'
permute: the ``row_gather`` kernel that spreads the bag gradients over the
sorted slots.  ``harness.layers`` files the permute under the lookup, whose
only metric on this cell reads ``pooled_row_gather`` alone, so it is
counted here, where its work belongs."""

from harness.card import bound_s
from harness.layers import layer_seconds

PERMUTE = "row_gather"
POOLED = "pooled_row_gather"


def permute_seconds(device) -> float:
    """Device seconds of the row gathers that are not the pooled gather."""
    return sum(b - a for name, a, b in device.ops
               if PERMUTE in name and POOLED not in name) / 1e6


def read(seg):
    seconds = layer_seconds(seg.device, "sparse_update") + permute_seconds(seg.device)
    if seconds <= 0 or seg.steps == 0 or "sparse_update" not in seg.bytes:
        return None
    return 100.0 * bound_s(seg.bytes["sparse_update"]) / (seconds / seg.steps)
