"""Trainer: the fit / evaluate loop around the steps (counterpart of
``torecsys_tpu/train/trainer.py``).

Per host batch: on the sparse route, presort the id streams on the host
(``data.presort``); move the batch to the device (:meth:`Trainer._place_batch`);
take the step.  The loop never waits on the device except where it reads
the loss or a metric: the copies to the card are asynchronous from pinned
memory, the step enqueues its kernels, and the presort of the next batch
runs on the host meanwhile.

Evaluation (``ctr``) accumulates streaming AUC and logloss on the device and
reads them once at the end.

Not ported yet: the automatic dense/sparse choice (its thresholds were
measured on a TPU), the on-device sort route, prefetch workers, ranking
evaluation (``ltr``/``emb``), checkpoints and meshes.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from torecsys_tpu_torch.data.presort import AUX_PREFIX, Presorter, build_presort_specs
from torecsys_tpu_torch.metrics import StreamingAUC, StreamingLogLoss
from torecsys_tpu_torch.train.pipeline import Pipeline
from torecsys_tpu_torch.train.sparse import sparse_modules
from torecsys_tpu_torch.train.state import TrainState
from torecsys_tpu_torch.train.steps import (
    make_eval_metrics_step,
    make_eval_step,
    make_train_step,
)

logger = logging.getLogger(__name__)


class Trainer:
    """Fits a :class:`Pipeline` on host-side batches (dicts of numpy arrays).

    Args:
        pipeline: a configured pipeline (``finalize`` is called here); the
            trainer runs on the pipeline's device.
        log_every: training-loss log cadence in steps (each log reads the
            loss on the host).
        seed: seed of the ``torch.Generator`` that :meth:`init_state` draws
            the parameters from.

    On the sparse route every training batch is presorted on the host: the
    port's sparse step takes only the presorted route.  The dense route
    builds no presorter.
    """

    def __init__(self, pipeline: Pipeline, log_every: int = 100, seed: int = 0):
        self.pipeline = pipeline.finalize()
        self.device = pipeline.device
        self.log_every = log_every
        self.seed = seed
        self.state: Optional[TrainState] = None
        self.history: List[Dict[str, float]] = []
        self._presorter: Optional[Presorter] = None
        self._train_step_fn = None
        self._eval_step_fn = None
        self._eval_metrics_fn = None
        self._auc = StreamingAUC()
        self._logloss = StreamingLogLoss()
        # Host wall time (ms) that train_steps spent presorting, placing and
        # enqueuing steps; the step itself runs on after its enqueue returns.
        self.host_ms = {"presort": 0.0, "place": 0.0, "step": 0.0}

    # ---- setup ----------------------------------------------------------

    def _build_steps(self) -> None:
        self._train_step_fn = make_train_step(self.pipeline)
        self._eval_step_fn = make_eval_step(self.pipeline)
        self._eval_metrics_fn = make_eval_metrics_step(self.pipeline, self._auc,
                                                       self._logloss)

    def init_state(self, example_batch: Optional[Dict[str, np.ndarray]] = None) -> TrainState:
        """Draw the parameters from ``seed`` and build the optimizer state of
        the pipeline's route.  ``example_batch`` is accepted for the JAX
        package's signature; torch modules know their shapes without one."""
        del example_batch
        seq = self.pipeline.sequential
        seq.reset_parameters(torch.Generator(device=self.device).manual_seed(self.seed))
        row_tx = self.pipeline.row_optimizer()
        modules = sparse_modules(seq)
        sparse = row_tx is not None and bool(modules)
        for module in modules.values():
            module.sparse_grads = sparse
        self.state = TrainState.create(seq, self.pipeline.optimizer, row_tx,
                                       set(modules) if sparse else None, self.device)
        self._presorter = (Presorter(build_presort_specs(self.pipeline.inputs))
                           if sparse else None)
        self._build_steps()
        return self.state

    def _place_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, object]:
        """Host batch → device tensors.  The presort's ``n_unique`` stays a
        host int: it sizes the update kernel's grid without a device read."""
        placed = {}
        for k, v in batch.items():
            if k.startswith(AUX_PREFIX) and k.endswith("/n_unique"):
                placed[k] = int(np.asarray(v).reshape(-1)[0])
                continue
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory()
            placed[k] = t.to(self.device, non_blocking=True)
        return placed

    # ---- training -------------------------------------------------------

    def train_steps(self, batches: Iterable[Dict[str, np.ndarray]]) -> List[torch.Tensor]:
        """Presort (sparse route), place and train on each host batch;
        returns the per-step losses as 0-d device tensors (nothing is read
        back here)."""
        if self.state is None:
            self.init_state()
        losses = []
        clock = time.perf_counter
        for batch in batches:
            t0 = clock()
            if self._presorter is not None:
                batch = self._presorter(batch)
            t1 = clock()
            placed = self._place_batch(batch)
            t2 = clock()
            self.state, logs = self._train_step_fn(self.state, placed)
            t3 = clock()
            losses.append(logs["loss"])
            for name, dt in (("presort", t1 - t0), ("place", t2 - t1), ("step", t3 - t2)):
                self.host_ms[name] += dt * 1e3
        return losses

    def _check_finite_loss(self, loss_sum: float, step: int) -> None:
        if not np.isfinite(loss_sum):
            raise RuntimeError(f"non-finite training loss at step {step} "
                               "(diverged training or bad input data)")

    def fit(self, train_loader: Iterable[Dict[str, np.ndarray]],
            val_loader: Optional[Iterable[Dict[str, np.ndarray]]] = None,
            max_epochs: int = 1, max_steps: Optional[int] = None) -> Dict[str, float]:
        """Run the training loop; returns the last epoch's metrics, with
        ``val_auc`` and ``val_logloss`` from :meth:`evaluate` after each
        epoch when ``val_loader`` is given.

        ``train_loader`` and ``val_loader`` may be re-iterable containers or
        zero-arg callables returning a fresh iterator per epoch.
        """
        if self.state is None:
            self.init_state()
        metrics: Dict[str, float] = {}
        step = 0
        for epoch in range(max_epochs):
            t0 = time.perf_counter()
            n_examples = 0
            self.state.reset_metrics()
            for batch in self._epoch_iter(train_loader):
                n_examples += next(v.shape[0] for k, v in batch.items()
                                   if not k.startswith(AUX_PREFIX))
                self.train_steps([batch])
                step += 1
                if step % self.log_every == 0:
                    mean = float(self.state.mean_loss())
                    self._check_finite_loss(mean, step)
                    logger.info("epoch %d step %d loss %.5f", epoch, step, mean)
                if max_steps is not None and step >= max_steps:
                    break
            mean = float(self.state.mean_loss())  # waits for the device
            self._check_finite_loss(mean, step)
            elapsed = max(time.perf_counter() - t0, 1e-9)
            metrics = {"epoch": epoch, "train_loss": mean,
                       "examples_per_sec": n_examples / elapsed}
            if val_loader is not None:
                metrics.update(self.evaluate(val_loader))
            logger.info("epoch %d done: %s", epoch, metrics)
            self.history.append(metrics)
            if max_steps is not None and step >= max_steps:
                break
        return metrics

    @staticmethod
    def _epoch_iter(loader):
        return iter(loader() if callable(loader) else loader)

    # ---- evaluation -----------------------------------------------------

    def evaluate(self, loader: Iterable[Dict[str, np.ndarray]]) -> Dict[str, float]:
        """Streaming AUC and logloss on the target field over a validation
        loader; the metric states stay on the device until the end."""
        if self.state is None:
            raise RuntimeError("call fit() or init_state() before evaluate()")
        target = self.pipeline.target_fields
        auc_state = self._auc.init(self.device)
        ll_state = self._logloss.init(self.device)
        for batch in self._epoch_iter(loader):
            if target not in batch:
                raise ValueError(f"evaluation batch is missing the target field {target!r} "
                                 f"(fields: {sorted(batch)})")
            auc_state, ll_state = self._eval_metrics_fn(
                self.state, self._place_batch(batch), auc_state, ll_state)
        return {"val_auc": float(self._auc.compute(auc_state)),
                "val_logloss": float(self._logloss.compute(ll_state))}

    def predict(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        """Probability scores ``(B, 1)`` of one host batch, on the device."""
        if self.state is None:
            raise RuntimeError("call fit() or init_state() before predict()")
        preds, _ = self._eval_step_fn(self.state, self._place_batch(batch))
        return preds


__all__ = ["Trainer"]
