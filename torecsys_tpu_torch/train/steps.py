"""Train step factory (counterpart of ``torecsys_tpu/train/steps.py``,
the sparse CTR step).

One step: forward with the sparse-route embeddings, ``loss.backward()``
(which leaves the dense gradients on the parameters and the per-slot table
gradients on each embedding's lookup leaf), the dense Adam step, then
``RowAdam.update_from_host_aux`` per table, which updates the touched rows
in place through the two kernels.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from torecsys_tpu_torch.train.pipeline import Pipeline
from torecsys_tpu_torch.train.sparse import sparse_modules
from torecsys_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]


def _split_batch(batch: Batch, pipeline: Pipeline) -> Tuple[Batch, Optional[torch.Tensor]]:
    """Pop the target field off the batch."""
    targets = batch.get(pipeline.target_fields)
    features = {k: v for k, v in batch.items() if k != pipeline.target_fields}
    return features, targets


def make_train_step(pipeline: Pipeline) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict]]:
    """Build the sparse train step ``(state, device batch) → (state, logs)``;
    the step updates the modules and ``state`` in place."""
    seq = pipeline.sequential
    criterion = pipeline.criterion
    row_tx = pipeline.row_optimizer()
    modules = sparse_modules(seq)

    def sparse_train_step(state: TrainState, batch: Batch):
        features, targets = _split_batch(batch, pipeline)
        for module in modules.values():
            module.take_lookup()  # drop what a failed earlier step left
        seq.train()
        dense_opt = state.opt_state["dense"]
        dense_opt.zero_grad(set_to_none=True)
        preds = seq(features)
        loss = criterion(preds, targets)
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
            state.step += 1
            state.loss_sum += loss.detach()
        state.loss_count += 1
        return state, {"loss": loss.detach()}

    return sparse_train_step


__all__ = ["make_train_step"]
