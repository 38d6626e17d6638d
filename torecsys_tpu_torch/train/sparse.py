"""Hybrid dense + sparse optimizer plumbing (counterpart of
``torecsys_tpu/train/sparse.py``).

The embedding tables of the sparse route are found structurally: every
table module (:class:`~torecsys_tpu_torch.inputs.embeddings.TableInput`:
``SingleIndexEmbedding``, ``MultiIndicesEmbedding`` and
``MultiIndicesFieldAwareEmbedding``) under the model owns one table, its
``embedding`` parameter.  The row-wise optimizer sees each table as its
``(R, W)`` stored rows (:meth:`TableInput.table_view`), so a field-aware
table's ``(N, Vp, W)`` has the slots of ``N*Vp`` rows.  The hybrid optimizer
state is::

    {"dense": <the named torch optimizer over the non-table parameters>,
     "sparse": {"<table parameter name>": <the row rule's slots>, ...}}

with the slots of the pipeline's row rule (``ops.sparse.get_row_optimizer``):
``{"mv": (R, 2, W)}`` of ``RowAdam`` (Adam, AdamW), ``{"v": (R, W)}`` of
``RowAdagrad``, ``{}`` of ``RowSGD``.

The dense route's state is the torch optimizer over every parameter, the
tables included (:meth:`TrainState.create`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from torecsys_tpu_torch.inputs.embeddings import TableInput

PARAM_NAME = "embedding"


def sparse_modules(seq: nn.Module) -> Dict[str, TableInput]:
    """``{table parameter name: owning module}`` of every sparse-route table."""
    return {
        f"{name}.{PARAM_NAME}" if name else PARAM_NAME: module
        for name, module in seq.named_modules()
        if isinstance(module, TableInput)
    }


def split_params(seq: nn.Module, table_paths) -> Tuple[Dict[str, nn.Parameter],
                                                       Dict[str, nn.Parameter]]:
    """Partition ``seq``'s named parameters into (dense, tables)."""
    named = dict(seq.named_parameters())
    tables = {k: v for k, v in named.items() if k in table_paths}
    dense = {k: v for k, v in named.items() if k not in table_paths}
    return dense, tables


def is_hybrid_opt_state(opt_state) -> bool:
    """True for the hybrid layout; the dense route's state is one torch
    optimizer over every parameter."""
    return isinstance(opt_state, dict) and "sparse" in opt_state


def init_hybrid_opt_state(optimizer_factory, row_tx, seq: nn.Module, table_paths) -> Dict:
    """Build the hybrid optimizer state over ``seq``'s partitioned
    parameters: row slots of each table's ``(R, W)`` stored rows."""
    from torecsys_tpu_torch.convert import flax_paths
    from torecsys_tpu_torch.train.optimizers import build_optimizer

    dense, tables = split_params(seq, table_paths)
    return {
        "dense": build_optimizer(optimizer_factory, dense, flax_paths(seq)),
        "sparse": {p: row_tx.init(t.detach().reshape(-1, t.shape[-1]))
                   for p, t in tables.items()},
    }


__all__ = ["init_hybrid_opt_state", "is_hybrid_opt_state", "sparse_modules", "split_params"]
