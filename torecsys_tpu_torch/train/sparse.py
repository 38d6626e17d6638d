"""Hybrid dense + sparse optimizer plumbing (counterpart of
``torecsys_tpu/train/sparse.py``).

The embedding tables of the sparse route are found structurally: every
:class:`~torecsys_tpu_torch.inputs.embeddings.MultiIndicesEmbedding` under
the model owns one table, its ``embedding`` parameter.  The hybrid optimizer
state is::

    {"dense": <torch Adam over the non-table parameters>,
     "sparse": {"<table parameter name>": {"mv": (R, 2, W)}, ...}}

The dense route's state is the torch optimizer over every parameter, the
tables included (:meth:`TrainState.create`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from torecsys_tpu_torch.inputs.embeddings import MultiIndicesEmbedding

PARAM_NAME = "embedding"


def sparse_modules(seq: nn.Module) -> Dict[str, MultiIndicesEmbedding]:
    """``{table parameter name: owning module}`` of every sparse-route table."""
    return {
        f"{name}.{PARAM_NAME}" if name else PARAM_NAME: module
        for name, module in seq.named_modules()
        if isinstance(module, MultiIndicesEmbedding)
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
    """Build the hybrid optimizer state over ``seq``'s partitioned parameters."""
    dense, tables = split_params(seq, table_paths)
    return {
        "dense": optimizer_factory(list(dense.values())),
        "sparse": {p: row_tx.init(t.detach()) for p, t in tables.items()},
    }


__all__ = ["init_hybrid_opt_state", "is_hybrid_opt_state", "sparse_modules", "split_params"]
