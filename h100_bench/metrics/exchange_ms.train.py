"""``exchange_ms.train``: rank 0's device ms a step in NCCL's kernels (the
psum of the bag sums over the table group), the wait for its peers
included: the kernels whose name holds ``nccl``.  None where none ran."""

MARK = "nccl"


def read(seg):
    seconds = sum(b - a for name, a, b in seg.device.ops if MARK in name.lower()) / 1e6
    if seconds <= 0 or seg.steps == 0:
        return None
    return seconds / seg.steps * 1e3
