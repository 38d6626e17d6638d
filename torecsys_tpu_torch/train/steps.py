"""Train and eval step factories (counterpart of ``torecsys_tpu/train/steps.py``,
the CTR steps).

The train step dispatches on the state's optimizer layout, chosen at
:meth:`TrainState.create`, as the JAX package's does:

* the sparse (hybrid) step: forward with the sparse-route embeddings,
  ``loss.backward()`` (which leaves the dense gradients on the parameters
  and the per-slot table gradients on each embedding's lookup leaf), the
  dense Adam step, then the row-wise update of each table's touched rows,
  in place through the kernels: ``update_from_host_aux`` when the batch
  carries presort aux (the trusted presorted route), else
  ``sort_slot_grads`` and ``update_sorted`` (the on-device route);
* the dense step: forward, ``loss.backward()`` (the table gradient is the
  scatter-add of the lookup's backward), and one Adam step over every
  parameter, the tables included.

Both run the model in ``train`` mode, where a BatchNorm normalizes with the
batch's statistics and moves its running statistics (the JAX package's
``batch_stats``, here module buffers) in place, in eager steps and in the
captured graph alike.

:func:`make_train_scan` runs K consecutive train steps as one dispatch (the
JAX package's ``lax.scan`` of the step): on the card, a CUDA graph that
captures the K steps, replayed once per dispatch.

The eval steps run the model in ``eval`` mode under ``torch.no_grad()``: a
BatchNorm normalizes with its running statistics.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from torecsys_tpu_torch.data.packed import BatchLayout
from torecsys_tpu_torch.ops.sparse import sort_slot_grads
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
    """Advance the device counters; the caller advances ``loss_count``."""
    with torch.no_grad():
        state.step += 1
        state.loss_sum += loss.detach()
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
                e = lookup.rows.shape[-1]
                g = lookup.rows.grad
                if g is None:
                    g = torch.zeros_like(lookup.rows)
                table, slots = module.table_view(), state.opt_state["sparse"][path]
                if lookup.aux is not None:
                    row_tx.update_from_host_aux(table, slots, g.reshape(-1, e), lookup.aux,
                                                state.step)
                    continue
                # A negative id in [-rows, 0) was read from row rows + id of
                # the logical view (jnp.take's rule): its update goes there too.
                ids, rows = lookup.ids, table.numel() // e
                b = ids.shape[0]
                ids = torch.where(ids < 0, ids + rows, ids)
                sorted_ids, g_sorted = sort_slot_grads(ids.reshape(b, -1), g.reshape(b, -1, e))
                row_tx.update_sorted(table, slots, sorted_ids, g_sorted, state.step)
        return _account(state, loss)

    def train_step(state: TrainState, batch: Batch):
        if is_hybrid_opt_state(state.opt_state):
            return sparse_train_step(state, batch)
        return dense_train_step(state, batch)

    return train_step


def _held_tensors(seq: torch.nn.Module, state: TrainState) -> List[torch.Tensor]:
    """Every tensor a train step reads or updates in place and keeps: the
    parameters, the buffers (a BatchNorm's running statistics among them),
    the optimizer state and the step and loss accumulators.  A CUDA graph
    holds them by address."""
    held = list(seq.parameters()) + list(seq.buffers()) + [state.step, state.loss_sum]
    opt = state.opt_state
    dense = opt["dense"] if is_hybrid_opt_state(opt) else opt
    for param_state in dense.state.values():
        held += [v for v in param_state.values() if isinstance(v, torch.Tensor)]
    if is_hybrid_opt_state(opt):
        for slots in opt["sparse"].values():
            held += list(slots.values())
    return held


class TrainScan:
    """K consecutive train steps as one dispatch (counterpart of the JAX
    package's ``make_train_scan``, a ``lax.scan`` of the step).

    A dispatch takes a packed ``(K, nbytes)`` uint8 group of K host batches
    of one :class:`BatchLayout` (pinned, for the card) and copies it with one
    non-blocking copy into a static buffer on the device; step ``k`` reads
    row ``k`` of it, and writes its loss into row ``k`` of a static ``(K,)``
    buffer, which the dispatch returns cloned.

    On the card the K steps are one CUDA graph.  The first dispatch runs
    them eagerly on a side stream (warm-up steps that count as training
    steps: they load every kernel and settle the caching allocator), then
    captures them with ``capture_error_mode="thread_local"``, so the
    prefetch workers may pin memory meanwhile; each later dispatch replays
    the graph once.  The graph holds the parameters and the optimizer state
    by address: a dispatch that finds one of them moved (a state replaced
    rather than copied into) captures again.  A failed capture raises.  On
    the CPU the K steps run eagerly in place of the graph.
    """

    def __init__(self, train_step, seq: torch.nn.Module, k: int, layout: BatchLayout,
                 device: torch.device):
        self.train_step = train_step
        self.seq = seq
        self.k = k
        self.layout = layout
        self.device = device
        self.static = torch.empty((k, layout.nbytes), dtype=torch.uint8, device=device)
        self.losses = torch.zeros(k, dtype=torch.float32, device=device)
        self._batches = [layout.unpack(self.static[i]) for i in range(k)]
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.graph = None
        self._held: Optional[List[int]] = None
        self.captures = 0
        self.replays = 0

    def _steps(self, state: TrainState) -> TrainState:
        for i, batch in enumerate(self._batches):
            state, logs = self.train_step(state, batch)
            self.losses[i].copy_(logs["loss"])
        return state

    def _held_ptrs(self, state: TrainState) -> List[int]:
        return [t.data_ptr() for t in _held_tensors(self.seq, state)]

    def _capture(self, state: TrainState) -> None:
        self.graph = None  # its memory pool goes before the new capture
        graph = torch.cuda.CUDAGraph()
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.graph(graph, stream=self._stream, capture_error_mode="thread_local"):
            self._steps(state)
        self.graph = graph
        self._held = self._held_ptrs(state)
        self.captures += 1

    def __call__(self, state: TrainState, packed: torch.Tensor) -> Tuple[TrainState, torch.Tensor]:
        """Take the K steps of ``packed``; returns the state (updated in
        place) and the ``(K,)`` float32 losses on the device."""
        if tuple(packed.shape) != (self.k, self.layout.nbytes):
            raise ValueError(f"packed group {tuple(packed.shape)} does not fit the scan's "
                             f"{(self.k, self.layout.nbytes)}")
        self.static.copy_(packed, non_blocking=True)
        if self._stream is None:
            return self._steps(state), self.losses.clone()
        if self.graph is None:
            current = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                state = self._steps(state)
            current.wait_stream(self._stream)
            losses = self.losses.clone()
            self._capture(state)
            return state, losses
        if self._held_ptrs(state) != self._held:
            self._capture(state)
        self.graph.replay()
        self.replays += 1
        return state, self.losses.clone()


def make_train_scan(train_step, seq: torch.nn.Module, k: int, layout: BatchLayout,
                    device: torch.device) -> TrainScan:
    """K steps of ``train_step`` per dispatch over packed groups of
    ``layout`` (:class:`TrainScan`)."""
    return TrainScan(train_step, seq, k, layout, device)


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


__all__ = ["TrainScan", "make_eval_metrics_step", "make_eval_step", "make_train_scan",
           "make_train_step"]
