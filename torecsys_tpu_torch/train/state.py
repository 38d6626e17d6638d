"""Train state (counterpart of ``torecsys_tpu/train/state.py``).

The parameters live in the modules; the state holds what the step carries
besides them: the optimizer state, the step counter and the loss
accumulators.  ``step`` and ``loss_sum`` are device tensors, so the training
loop never waits on the device to count or accumulate.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


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
        from torecsys_tpu_torch.train.sparse import init_hybrid_opt_state

        if row_tx is not None and table_paths:
            opt_state = init_hybrid_opt_state(optimizer_factory, row_tx, seq, table_paths)
        else:
            opt_state = optimizer_factory(list(seq.parameters()))
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


__all__ = ["TrainState"]
