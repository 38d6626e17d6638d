"""Training pipeline builder (counterpart of ``torecsys_tpu/train/pipeline.py``).

The port carries the three objectives: ``ctr`` on both embedding routes,
``ltr`` and ``emb`` (with a miner, ``set_miner`` and
``set_miner_target_field``) on the dense route, and a regularizer
(``set_regularizer``) on each; the setters are ``set_objective``,
``set_inputs``, ``set_model``, ``set_criterion``, ``set_optimizer``,
``set_regularizer``, ``set_miner``, ``set_miner_target_field``,
``set_sparse_embeddings``, ``set_compute_dtype``, ``set_table_dtype`` and
``set_target_fields``.  ``set_sparse_embeddings(True)`` selects the sparse
(touched-rows-only) route, ``False`` the dense one, and ``None`` (the
default) the automatic choice, which the Trainer makes from the tables' size
with thresholds measured on the card (``train/trainer.py``).  A bf16 table,
the ``ltr`` and ``emb`` objectives, an optimizer without a row-wise twin and
an opaque optimizer factory keep the dense route; with them
``set_sparse_embeddings(True)`` raises, as in the JAX package.

A torch module is built on its device with its widths known, so the
pipeline holds the ``device`` its model is built on (default: the card) and
builds the model from the inputs it was given (``set_inputs`` first).

:meth:`Pipeline.build` assembles a pipeline from JSON-style configs (the
CLI's entry), :meth:`Pipeline.summary` prints its components, and
``load_from`` names a checkpoint the Trainer restores.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from torch import nn

from torecsys_tpu_torch.inputs import Inputs
from torecsys_tpu_torch.layers.precision import (
    apply_compute_dtype,
    apply_table_dtype,
    is_reduced,
    resolve_dtype,
)
from torecsys_tpu_torch.layers.regularization import Regularizer
from torecsys_tpu_torch.losses import BCEWithLogitsLoss, get_loss
from torecsys_tpu_torch.miners import BaseMiner, get_miner
from torecsys_tpu_torch.models import Sequential, get_model
from torecsys_tpu_torch.train.optimizers import get_optimizer
from torecsys_tpu_torch.utils import DeviceLike, resolve_device

OBJECTIVES = ("ctr", "emb", "ltr")


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
        self.regularizer: Optional[Regularizer] = None
        self.miner: Optional[BaseMiner] = None
        self.miner_target_field: Optional[str] = None
        self.num_negs = 1
        self.target_fields = "label"
        # True: sparse route; False: dense route; None: the Trainer's
        # automatic choice.
        self.sparse_embeddings: Optional[bool] = None
        self.compute_dtype: Optional[str] = None
        self.table_dtype: Optional[str] = None
        # a checkpoint the Trainer restores (Trainer(load_from=...) wins)
        self.load_from: Optional[str] = None

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

    def set_optimizer(self, optimizer="Adam", **kwargs) -> "Pipeline":
        """A registry name (``train.optimizers.get_optimizer``) with its
        keywords, or the opaque form: a factory ``params ->
        torch.optim.Optimizer``, the port's counterpart of an opaque optax
        transform, which has no row-wise twin (``optimizer_spec`` None: the
        tables stay on the dense route)."""
        if isinstance(optimizer, str):
            self.optimizer = get_optimizer(optimizer, **kwargs)
            self.optimizer_spec = {"method": optimizer, **kwargs}
        elif callable(optimizer):
            if kwargs:
                raise TypeError(f"an optimizer factory takes no keywords, got {sorted(kwargs)}")
            self.optimizer = optimizer
            self.optimizer_spec = None
        else:
            raise TypeError(f"set_optimizer takes a registry name or a factory "
                            f"params -> torch.optim.Optimizer, got {optimizer!r}")
        return self

    def set_regularizer(self, regularizer: Optional[Regularizer] = None,
                        **kwargs) -> "Pipeline":
        """A :class:`Regularizer`, or one built from ``kwargs``
        (``weight_decay``, ``norm``, ``key_filter``)."""
        self.regularizer = regularizer if regularizer is not None else Regularizer(**kwargs)
        return self

    def set_miner(self, miner, **kwargs) -> "Pipeline":
        """A miner instance or registry name (``ltr``/``emb``); its
        ``num_negs`` becomes the pipeline's."""
        self.miner = get_miner(miner, **kwargs)
        if hasattr(self.miner, "num_negs"):
            self.num_negs = self.miner.num_negs
        return self

    def set_miner_target_field(self, field: str) -> "Pipeline":
        self.miner_target_field = field
        return self

    def set_sparse_embeddings(self, enabled: Optional[bool]) -> "Pipeline":
        self.sparse_embeddings = enabled
        return self

    def set_compute_dtype(self, dtype: Optional[str]) -> "Pipeline":
        """``'bfloat16'`` runs the dense towers' products in bf16 (float32
        parameters, float32 loss); None or ``'float32'`` keeps float32."""
        resolve_dtype(dtype)
        self.compute_dtype = dtype
        return self

    def set_table_dtype(self, dtype: Optional[str]) -> "Pipeline":
        """The embedding tables' storage dtype (``'bfloat16'``, or None /
        ``'float32'``).  A bf16 table halves the dense route's table and
        Adam-moment traffic; its rows are cast to float32 at the lookup.  It
        keeps the pipeline on the dense route, and ``finalize`` refuses it
        with ``set_sparse_embeddings(True)``."""
        resolve_dtype(dtype)
        self.table_dtype = dtype
        return self

    def set_target_fields(self, fields: str) -> "Pipeline":
        self.target_fields = fields
        return self

    def row_optimizer(self):
        """The row-wise (lazy) optimizer of the embedding tables, or None on
        the dense route, as the JAX package decides it: None under
        ``set_sparse_embeddings(False)``, with a bf16 table, for the ``ltr``
        and ``emb`` objectives, for an opaque optimizer factory and for a
        named optimizer without a row-wise twin (``get_row_optimizer``:
        Adam, AdamW, Adagrad and plain SGD have one; Lamb or
        ``SGD(momentum=0.9)`` do not).  Under ``set_sparse_embeddings(True)``
        the last three raise ``ValueError``."""
        from torecsys_tpu_torch.ops.sparse import get_row_optimizer

        if self.sparse_embeddings is False or is_reduced(self.table_dtype):
            return None
        if self.objective != "ctr":
            if self.sparse_embeddings is True:
                raise ValueError(f"sparse_embeddings=True requires objective='ctr' "
                                 f"(got {self.objective!r})")
            return None
        if self.optimizer_spec is None:
            if self.sparse_embeddings is True:
                raise ValueError("sparse_embeddings=True requires a named optimizer "
                                 "(set_optimizer('Adam', ...)), not an opaque transform")
            return None
        spec = dict(self.optimizer_spec)
        row = get_row_optimizer(spec.pop("method", "Adam"), **spec)
        if row is None and self.sparse_embeddings is True:
            raise ValueError(
                f"optimizer {self.optimizer_spec!r} has no row-wise (lazy) "
                "formulation; supported: Adam, AdamW, Adagrad, SGD(plain)"
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
        if self.objective in ("ltr", "emb"):
            if self.miner is None:
                self.set_miner("UniformBatchMiner")
            if self.miner_target_field is None:
                raise ValueError(f"objective {self.objective!r} requires set_miner_target_field")
        if self.sparse_embeddings not in (True, False, None):
            raise ValueError(f"sparse_embeddings must be True, False or None, got "
                             f"{self.sparse_embeddings!r}")
        if is_reduced(self.table_dtype) and self.sparse_embeddings:
            raise ValueError(
                f"table_dtype={self.table_dtype!r} requires the dense embedding path: the "
                "sparse touched-rows kernels store float32 rows.  Unset sparse_embeddings "
                "or table_dtype."
            )
        apply_compute_dtype(self.sequential, self.compute_dtype)
        apply_table_dtype(self.sequential, self.table_dtype)
        return self

    def summary(self) -> str:
        """Human-readable component table."""
        rows = [
            ("objective", self.objective),
            ("inputs", type(self.inputs).__name__ if self.inputs is not None else "-"),
            ("model", type(self.model).__name__ if self.model is not None else "-"),
            ("criterion", type(self.criterion).__name__ if self.criterion else "-"),
            ("optimizer", "set" if self.optimizer is not None else "-"),
            ("regularizer", repr(self.regularizer) if self.regularizer else "-"),
            ("miner", type(self.miner).__name__ if self.miner else "-"),
            ("miner_target_field", self.miner_target_field or "-"),
            ("target_fields", self.target_fields),
            ("sparse_embeddings", {None: "auto", True: "on",
                                   False: "off"}[self.sparse_embeddings]),
            ("compute_dtype", self.compute_dtype or "float32"),
            ("table_dtype", self.table_dtype or "float32"),
            ("device", str(self.device)),
        ]
        width = max(len(k) for k, _ in rows)
        return "\n".join(f"{k:{width}s} : {v}" for k, v in rows)

    @classmethod
    def build(cls, device: DeviceLike = None, **config) -> "Pipeline":
        """Assemble a pipeline on ``device`` (default: the card) from a
        JSON-style config; sub-configs are ``{"method": <registry name>,
        ...kwargs}`` dicts::

            Pipeline.build(
                objective="ctr",
                inputs_config=inputs_instance,
                model_config={"method": "DeepFM", "deep_layer_sizes": [64, 64]},
                criterion_config={"method": "BCEWithLogitsLoss"},
                optimizer_config={"method": "Adam", "lr": 1e-3},
                regularizer_config={"weight_decay": 0.01},
                target_fields="label",
            )

        Also ``miner_config`` (``{"method": "UniformBatchMiner",
        "num_negs": 4}``) and ``miner_target_field`` for ``ltr``/``emb``,
        ``sparse_embeddings``, ``compute_dtype``, ``table_dtype`` and
        ``load_from``.
        """
        p = cls(device=device)
        p.set_objective(config.get("objective", "ctr"))
        if config.get("inputs_config") is not None:
            p.set_inputs(config["inputs_config"])
        if config.get("model_config") is not None:
            mc = dict(config["model_config"])
            p.set_model(mc.pop("method"), **mc)
        if config.get("criterion_config") is not None:
            cc = dict(config["criterion_config"])
            p.set_criterion(cc.pop("method"), **cc)
        if config.get("optimizer_config") is not None:
            oc = dict(config["optimizer_config"])
            p.set_optimizer(oc.pop("method", "Adam"), **oc)
        if config.get("regularizer_config") is not None:
            p.set_regularizer(**config["regularizer_config"])
        if config.get("miner_config") is not None:
            mc = dict(config["miner_config"])
            p.set_miner(mc.pop("method", "UniformBatchMiner"), **mc)
        if config.get("miner_target_field") is not None:
            p.set_miner_target_field(config["miner_target_field"])
        if config.get("target_fields") is not None:
            p.set_target_fields(config["target_fields"])
        if "sparse_embeddings" in config:
            p.set_sparse_embeddings(config["sparse_embeddings"])
        if config.get("compute_dtype") is not None:
            p.set_compute_dtype(config["compute_dtype"])
        if config.get("table_dtype") is not None:
            p.set_table_dtype(config["table_dtype"])
        if config.get("load_from") is not None:
            p.load_from = config["load_from"]
        return p


__all__ = ["OBJECTIVES", "Pipeline"]
