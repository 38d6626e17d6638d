"""Weight regularization as a differentiable loss term (counterpart of
``torecsys_tpu/layers/regularization.py``)."""

from __future__ import annotations

import dataclasses

from torecsys_tpu_torch.utils.operations import regularize


@dataclasses.dataclass(frozen=True)
class Regularizer:
    """Callable config: ``reg(module) → weight_decay * Σ |p|^norm`` over the
    parameters whose flax path contains ``key_filter``
    (:func:`~torecsys_tpu_torch.utils.operations.regularize`): ``kernel``
    (the default) selects the dense kernels, a table's name its table."""

    weight_decay: float = 0.01
    norm: int = 2
    key_filter: str = "kernel"

    def __call__(self, params, group_sum=None, sharded=()):
        """The penalty of ``params``; ``group_sum`` and ``sharded`` take a
        row-sharded table's whole (``regularize``)."""
        return regularize(params, weight_decay=self.weight_decay, norm=self.norm,
                          key_filter=self.key_filter, group_sum=group_sum, sharded=sharded)


__all__ = ["Regularizer"]
