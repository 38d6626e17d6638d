"""Touched-rows-only embedding updates: lazy row-wise Adam.

Counterpart of ``torecsys_tpu/ops/sparse.py`` on the trusted presorted
route.  The train step never builds a dense ``(V, E)`` table gradient: the
embedding module hands out its looked-up rows as a leaf tensor, autograd
fills in the per-slot gradient ``(B, N, E)``, and :class:`RowAdam` applies
Adam to just the stored rows the batch touched.  The host presort
(``data.presort``) supplies the sort order, in-row slots, segment ids and the
compact unique stored-row ids, so the device does three passes:

1. permute the narrow ``(M, E)`` grads into id order (``index_select``);
2. sum them per stored row, widened to ``(M, P*E)`` (:func:`_sorted_gsum`:
   the ``widen_segment_sum`` kernel, or ``segment_sum_wide`` at ``P == 1``);
3. update the unique rows in place (the ``fused_rowwise_update`` kernel).

Semantics are those of the JAX package: lazy Adam (rows absent from a batch
keep their moments), global-step bias correction, decoupled weight decay,
and stored-row granularity (a logical row sharing a stored row with a
touched one sees a zero gradient).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from torecsys_tpu_torch.ops.kernels import sparse_update as K


def _sorted_gsum(g_sorted: torch.Tensor, lo: torch.Tensor, seg: torch.Tensor,
                 pack: int) -> torch.Tensor:
    """Segment-sum a sorted NARROW grad stream into wide stored-row sums.

    ``pack == 1`` (E >= 128 after packing) has no widen to do and takes the
    ``segment_sum_wide`` kernel; every other pack ``widen_segment_sum``.
    """
    if pack == 1:
        return K.segment_sum_wide(g_sorted, seg)
    return K.widen_segment_sum(g_sorted, lo, seg, pack)


@dataclasses.dataclass(frozen=True)
class RowAdam:
    """Lazy row-wise Adam(W) over a packed embedding table.

    Slot layout: one ``mv`` tensor of shape ``(R, 2, W)`` holding m and v of
    each stored row side by side (``[:, 0]`` = m, ``[:, 1]`` = v), so one
    touched row's moments are one contiguous read and write.
    """

    learning_rate: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, table: torch.Tensor) -> Dict[str, torch.Tensor]:
        shape = tuple(table.shape[:-1]) + (2, table.shape[-1])
        return {"mv": torch.zeros(shape, dtype=table.dtype, device=table.device)}

    def hyper_and_rule(self, step: torch.Tensor):
        """The ``(7,)`` float32 hyperparameter vector on ``step``'s device.

        ``step`` is the 0-d int tensor of completed steps; bias correction
        uses ``t = step + 1``, computed in float32 as the JAX package does.
        Everything stays on the device: no host read, no host copy.
        """
        dev = step.device
        t = (step + 1).to(torch.float32)

        def const(x):
            return torch.full((), x, dtype=torch.float32, device=dev)

        b1, b2 = const(self.b1), const(self.b2)
        bc1 = 1.0 / (1.0 - torch.pow(b1, t))
        bc2 = 1.0 / (1.0 - torch.pow(b2, t))
        hyper = torch.stack([const(self.learning_rate), b1, b2, const(self.eps),
                             const(self.weight_decay), bc1, bc2])
        return hyper, "adam"

    def update(self, table: torch.Tensor, slots: Dict[str, torch.Tensor],
               uids: torch.Tensor, gsum: torch.Tensor, step: torch.Tensor,
               n_valid: int):
        """Update the first ``n_valid`` unique rows ``uids`` in place."""
        hyper, rule = self.hyper_and_rule(step)
        K.fused_rowwise_update(uids, gsum, table, (slots["mv"],), hyper, rule, n_valid)
        return table, slots

    def update_from_host_aux(self, table: torch.Tensor, slots: Dict[str, torch.Tensor],
                             flat_g: torch.Tensor, aux: Dict, step: torch.Tensor):
        """Trusted PRESORTED route, in place.

        Args:
            table: ``(R, P*E)`` packed stored table.
            slots: ``{"mv": (R, 2, P*E)}``.
            flat_g: ``(M, E)`` per-slot grads in original slot order.
            aux: ``order``, ``lo``, ``seg``, ``uids`` (``(M,)`` int32 on the
                table's device) and ``n_unique`` (host int) from the port's
                :class:`~torecsys_tpu_torch.data.presort.Presorter`, which
                has checked that every id addresses a row of ``table``.
            step: 0-d int tensor of completed steps.
        """
        e = flat_g.shape[-1]
        pack = table.shape[-1] // e
        g_sorted = flat_g.index_select(0, aux["order"])
        gsum = _sorted_gsum(g_sorted, aux["lo"], aux["seg"], pack)
        return self.update(table, slots, aux["uids"], gsum, step,
                           n_valid=int(aux["n_unique"]))


def get_row_optimizer(method: str = "Adam", lr: float = 1e-3, **kwargs) -> Optional[RowAdam]:
    """Row-wise twin of ``train.optimizers.get_optimizer``; None when the
    optimizer has no row-wise formulation in the port (only Adam so far)."""
    lr = kwargs.pop("learning_rate", lr)
    if method.lower() != "adam":
        return None
    try:
        return RowAdam(learning_rate=lr, **kwargs)
    except TypeError:  # unsupported kwarg for this optimizer
        return None


__all__ = ["RowAdam", "get_row_optimizer"]
