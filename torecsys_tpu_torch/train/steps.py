"""Train and eval step factories (counterpart of ``torecsys_tpu/train/steps.py``,
the CTR steps).

The train step dispatches on the state's optimizer layout, chosen at
:meth:`TrainState.create`, as the JAX package's does:

* the sparse (hybrid) step: forward with the sparse-route embeddings,
  ``loss.backward()`` (which leaves the dense gradients on the parameters
  and the per-slot table gradients on each embedding's lookup leaf), the
  dense Adam step, then ``RowAdam.update_from_host_aux`` per table, which
  updates the touched rows in place through the kernels;
* the dense step: forward, ``loss.backward()`` (the table gradient is the
  scatter-add of the lookup's backward), and one Adam step over every
  parameter, the tables included.

The eval steps run the model in ``eval`` mode under ``torch.no_grad()``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from torecsys_tpu_torch.train.pipeline import Pipeline
from torecsys_tpu_torch.train.sparse import is_hybrid_opt_state, sparse_modules
from torecsys_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]


def _split_batch(batch: Batch, pipeline: Pipeline) -> Tuple[Batch, Optional[torch.Tensor]]:
    """Pop the target field off the batch."""
    targets = batch.get(pipeline.target_fields)
    features = {k: v for k, v in batch.items() if k != pipeline.target_fields}
    return features, targets


def _account(state: TrainState, loss: torch.Tensor) -> Tuple[TrainState, Dict]:
    with torch.no_grad():
        state.step += 1
        state.loss_sum += loss.detach()
    state.loss_count += 1
    return state, {"loss": loss.detach()}


def make_train_step(pipeline: Pipeline) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict]]:
    """Build the train step ``(state, device batch) → (state, logs)``; the
    step updates the modules and ``state`` in place."""
    seq = pipeline.sequential
    criterion = pipeline.criterion
    modules = sparse_modules(seq)

    def dense_train_step(state: TrainState, batch: Batch):
        features, targets = _split_batch(batch, pipeline)
        seq.train()
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        loss = criterion(seq(features), targets)
        loss.backward()
        opt.step()
        return _account(state, loss)

    def sparse_train_step(state: TrainState, batch: Batch):
        row_tx = pipeline.row_optimizer()
        features, targets = _split_batch(batch, pipeline)
        for module in modules.values():
            module.take_lookup()  # drop what a failed earlier step left
        seq.train()
        dense_opt = state.opt_state["dense"]
        dense_opt.zero_grad(set_to_none=True)
        loss = criterion(seq(features), targets)
        loss.backward()
        dense_opt.step()
        with torch.no_grad():
            for path, module in modules.items():
                lookup = module.take_lookup()
                if lookup is None:
                    raise RuntimeError(f"embedding {path!r} was not applied in the step")
                if lookup.aux is None:
                    raise NotImplementedError(
                        "the on-device sparse route is not ported: presort the batch "
                        "(data.presort.Presorter)"
                    )
                e = lookup.rows.shape[-1]
                g = lookup.rows.grad
                if g is None:
                    g = torch.zeros_like(lookup.rows)
                row_tx.update_from_host_aux(
                    module.embedding.detach(), state.opt_state["sparse"][path],
                    g.reshape(-1, e), lookup.aux, state.step,
                )
        return _account(state, loss)

    def train_step(state: TrainState, batch: Batch):
        if is_hybrid_opt_state(state.opt_state):
            return sparse_train_step(state, batch)
        return dense_train_step(state, batch)

    return train_step


def make_eval_step(pipeline: Pipeline):
    """Build the eval step ``(state, device batch) → (probabilities, targets)``:
    a sigmoid over raw-score models (models that already emit probabilities
    set ``outputs_probability = True``)."""
    seq = pipeline.sequential
    model_emits_prob = bool(getattr(pipeline.model, "outputs_probability", False))

    def eval_step(state: TrainState, batch: Batch):
        del state  # the parameters live in the modules
        features, targets = _split_batch(batch, pipeline)
        seq.eval()
        with torch.no_grad():
            preds = seq(features)
            if not model_emits_prob:
                preds = torch.sigmoid(preds)
        return preds, targets

    return eval_step


def make_eval_metrics_step(pipeline: Pipeline, auc, logloss):
    """Eval step with on-device streaming-metric accumulation:
    ``(state, batch, auc_state, ll_state) → (auc_state, ll_state)``; nothing
    is read back until ``compute``."""
    eval_step = make_eval_step(pipeline)

    def step(state: TrainState, batch: Batch, auc_state, ll_state):
        preds, targets = eval_step(state, batch)
        with torch.no_grad():
            return auc.update(auc_state, preds, targets), logloss.update(ll_state, preds, targets)

    return step


__all__ = ["make_eval_metrics_step", "make_eval_step", "make_train_step"]
