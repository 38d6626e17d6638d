"""Train state (counterpart of ``torecsys_tpu/train/state.py``).

The parameters live in the modules, and so do the running statistics that
the JAX package's state carries as ``batch_stats``: the model's persistent
buffers (:func:`batch_stats`), which a train step moves in place.  The
state holds what the step carries besides them: the optimizer state, the
step counter and the loss accumulators.  ``step`` and ``loss_sum`` are
device tensors, so the training loop never waits on the device to count or
accumulate, and a CUDA graph of the step advances them on its own.
``loss_count`` is a host int that the trainer advances by the steps of each
dispatch (a graph replay runs no Python).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch import nn


def batch_stats(seq: nn.Module) -> Dict[str, torch.Tensor]:
    """``{name: buffer}`` of ``seq``'s persistent buffers, the port's
    ``batch_stats`` (the BatchNorms' ``mean`` and ``var``); the tensors
    themselves, not copies."""
    params = {name for name, _ in seq.named_parameters()}
    return {name: t for name, t in seq.state_dict(keep_vars=True).items() if name not in params}


@dataclasses.dataclass
class TrainState:
    opt_state: Any
    step: torch.Tensor      # 0-d int32 on the device: completed steps
    loss_sum: torch.Tensor  # 0-d float32 on the device
    loss_count: int = 0

    @classmethod
    def create(cls, seq, optimizer_factory, row_tx, table_paths, device) -> "TrainState":
        """Build the initial state on ``device``.

        With ``row_tx`` and ``table_paths`` set, the optimizer state is the
        hybrid layout (``train.sparse``): the dense optimizer over the
        non-table parameters plus row-wise slots per table.  Otherwise it is
        one ``optimizer_factory`` optimizer over every parameter, the tables
        included (the dense route).
        """
        from torecsys_tpu_torch.convert import flax_paths
        from torecsys_tpu_torch.train.optimizers import build_optimizer
        from torecsys_tpu_torch.train.sparse import init_hybrid_opt_state

        if row_tx is not None and table_paths:
            opt_state = init_hybrid_opt_state(optimizer_factory, row_tx, seq, table_paths)
        else:
            opt_state = build_optimizer(optimizer_factory, dict(seq.named_parameters()),
                                        flax_paths(seq))
        return cls(
            opt_state=opt_state,
            step=torch.zeros((), dtype=torch.int32, device=device),
            loss_sum=torch.zeros((), dtype=torch.float32, device=device),
        )

    def mean_loss(self) -> torch.Tensor:
        return self.loss_sum / max(self.loss_count, 1)

    def reset_metrics(self) -> None:
        self.loss_sum.zero_()
        self.loss_count = 0


__all__ = ["TrainState", "batch_stats"]
