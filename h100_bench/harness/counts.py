"""Operations and bytes that a CTR step needs, from the configuration's shapes
and the step's batch, whatever kernels compute them.

Each input byte is read once and each output byte written once; sizes that
depend on the data (distinct ids and stored rows of a step) come from the
step's batch (``stats``: ``ids``, ``logical_rows``, ``stored_rows``).  A
GEMM of ``m x k`` by ``k x n`` is ``2 m k n`` operations; a tower's backward
takes twice its forward's GEMMs (the input's gradient, which the rows need,
and the weight's).  Elementwise work is counted at the float32 rate.
"""

from __future__ import annotations

from typing import Dict, Sequence

F32 = 4
ID_BYTES = 4          # the batch's int32 ids
ADAM_OPS = 14         # operations of one Adam update of one element


def tower_gemm_ops(batch: int, widths: Sequence[int]) -> float:
    """Forward and backward GEMM operations of a dense tower whose layer
    widths (input first, output last) are ``widths``."""
    fwd = sum(2.0 * batch * a * b for a, b in zip(widths, widths[1:]))
    return 3.0 * fwd


def tower_params(widths: Sequence[int]) -> int:
    return sum(a * b + b for a, b in zip(widths, widths[1:]))


def lookup_bytes(cfg: Dict, stats: Dict) -> float:
    """The lookup: the ids read, each distinct logical row read once, the
    ``(M, E)`` rows written."""
    e = cfg["embed_size"]
    return stats["ids"] * ID_BYTES + stats["logical_rows"] * e * F32 + stats["ids"] * e * F32


def sparse_update_bytes(cfg: Dict, stats: Dict) -> float:
    """The sparse update: the ``(M, E)`` per-slot gradients and their ids read;
    each touched stored row of the table and of its two moments read and
    written."""
    width = cfg["embed_size"] * cfg["rows_per_stored_row"]
    return (stats["ids"] * (cfg["embed_size"] * F32 + ID_BYTES)
            + 2 * 3 * stats["stored_rows"] * width * F32)


def sparse_path_float32_ops(cfg: Dict, stats: Dict) -> float:
    """The row update's float32 operations."""
    return ADAM_OPS * stats["stored_rows"] * cfg["embed_size"] * cfg["rows_per_stored_row"]


__all__ = ["ADAM_OPS", "lookup_bytes", "sparse_path_float32_ops", "sparse_update_bytes",
           "tower_gemm_ops", "tower_params"]
