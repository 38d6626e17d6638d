"""Training pipeline builder (counterpart of ``torecsys_tpu/train/pipeline.py``).

The port carries the ``ctr`` objective on both embedding routes:
``set_objective("ctr")``, ``set_inputs``, ``set_model``, ``set_criterion``,
``set_optimizer``, ``set_sparse_embeddings`` and ``set_target_fields``.
``set_sparse_embeddings(True)`` selects the sparse (touched-rows-only)
route, ``False`` the dense one; the JAX package's automatic choice
(``None``) is not ported, because its thresholds were measured on a TPU.

A torch module is built on its device with its widths known, so the
pipeline holds the ``device`` its model is built on (default: the card) and
builds the model from the inputs it was given (``set_inputs`` first).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from torch import nn

from torecsys_tpu_torch.inputs import Inputs
from torecsys_tpu_torch.losses import BCEWithLogitsLoss, get_loss
from torecsys_tpu_torch.models import Sequential, get_model
from torecsys_tpu_torch.train.optimizers import get_optimizer
from torecsys_tpu_torch.utils import DeviceLike, resolve_device

OBJECTIVES = ("ctr",)


class Pipeline:
    """Mutable builder collecting every component of a training run; the
    ``set_*`` setters chain.  :class:`~torecsys_tpu_torch.train.Trainer`
    consumes the finished object."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.objective = "ctr"
        self.inputs: Optional[Inputs] = None
        self.model: Optional[nn.Module] = None
        self.sequential: Optional[Sequential] = None
        self.criterion: Optional[Callable] = None
        self.optimizer: Any = None
        self.optimizer_spec: Optional[Dict[str, Any]] = None
        self.target_fields = "label"
        # True: sparse route; False: dense route; None (the JAX package's
        # automatic choice) is refused by finalize().
        self.sparse_embeddings: Optional[bool] = None

    def set_objective(self, objective: str) -> "Pipeline":
        if objective not in OBJECTIVES:
            raise ValueError(f"objective must be one of {OBJECTIVES}, got {objective!r}")
        self.objective = objective
        return self

    def set_inputs(self, inputs: Inputs) -> "Pipeline":
        self.inputs = inputs.to(self.device)
        self._refresh_sequential()
        return self

    def set_model(self, model, **kwargs) -> "Pipeline":
        """A model instance, or a registry name built from the inputs' widths
        on the pipeline's device."""
        if isinstance(model, nn.Module):
            self.model = model.to(self.device)
        else:
            if self.inputs is None:
                raise ValueError("set_inputs before set_model: the model's widths come from them")
            self.model = get_model(model, inputs=self.inputs, device=self.device, **kwargs)
        self._refresh_sequential()
        return self

    def set_criterion(self, criterion, **kwargs) -> "Pipeline":
        self.criterion = get_loss(criterion, **kwargs)
        return self

    def set_optimizer(self, optimizer: str = "Adam", **kwargs) -> "Pipeline":
        self.optimizer = get_optimizer(optimizer, **kwargs)
        self.optimizer_spec = {"method": optimizer, **kwargs}
        return self

    def set_sparse_embeddings(self, enabled: Optional[bool]) -> "Pipeline":
        self.sparse_embeddings = enabled
        return self

    def set_target_fields(self, fields: str) -> "Pipeline":
        self.target_fields = fields
        return self

    def row_optimizer(self):
        """The row-wise (lazy) optimizer of the embedding tables, or None on
        the dense route."""
        from torecsys_tpu_torch.ops.sparse import get_row_optimizer

        if self.sparse_embeddings is False:
            return None
        spec = dict(self.optimizer_spec)
        row = get_row_optimizer(spec.pop("method", "Adam"), **spec)
        if row is None:
            raise ValueError(
                f"optimizer {self.optimizer_spec!r} has no row-wise formulation in the port "
                "(supported: Adam)"
            )
        return row

    def _refresh_sequential(self) -> None:
        if self.inputs is not None and self.model is not None:
            self.sequential = Sequential(self.inputs, self.model)

    def finalize(self) -> "Pipeline":
        """Fill defaults and validate completeness."""
        if self.sequential is None:
            raise ValueError("pipeline incomplete: set_inputs and set_model are required")
        if self.criterion is None:
            self.criterion = BCEWithLogitsLoss()
        if self.optimizer is None:
            self.set_optimizer("Adam", lr=1e-3)
        if self.sparse_embeddings is None:
            raise NotImplementedError(
                "the automatic dense/sparse choice is not ported (its thresholds were "
                "measured on a TPU): call set_sparse_embeddings(True) for the sparse "
                "route or set_sparse_embeddings(False) for the dense route"
            )
        if self.sparse_embeddings not in (True, False):
            raise ValueError(
                f"sparse_embeddings must be True or False, got {self.sparse_embeddings!r}")
        return self


__all__ = ["OBJECTIVES", "Pipeline"]
