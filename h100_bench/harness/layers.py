"""Which layer of the program each device operation of a trace belongs to.

Inside a CUDA graph replay the profiler sees kernels and copies but no host
operation that launched them, so operations are attributed by name:

* ``lookup``: the row gather (the port's ``row_gather`` kernel, which also
  permutes the per-slot gradients into id order) and ATen's index-select
  gathers;
* ``sparse_update``: the id sort and the dedup (radix sort, prefix scan,
  the unique rows' scatter), the segment sums (the port's tiled kernels) and
  the row update (``rowwise_update``, the fused dedup update);
* ``copy``: memcpy and memset;
* ``dense``: every other kernel: the model, the loss and the dense
  optimizer, the step's own counters.

A kernel that a later change renames or adds to the lookup or the sparse
update lands in ``dense`` until this list learns it.
"""

from __future__ import annotations

SPARSE_MARKS = ("rowwise_update", "tile_kernel", "fixup_kernel", "dedup", "sort", "scan",
                "scatter")
LOOKUP_MARKS = ("row_gather", "indexselect", "vectorized_gather")
COPY_PREFIXES = ("memcpy", "memset")


def layer_of(name: str) -> str:
    low = name.lower()
    if low.startswith(COPY_PREFIXES):
        return "copy"
    if any(m in low for m in SPARSE_MARKS):
        return "sparse_update"
    if any(m in low for m in LOOKUP_MARKS):
        return "lookup"
    return "dense"


def layer_seconds(device, layer: str) -> float:
    """Device seconds of ``layer``'s operations in a traced window (the sum of
    their durations)."""
    return sum(b - a for name, a, b in device.ops if layer_of(name) == layer) / 1e6


__all__ = ["layer_of", "layer_seconds"]
