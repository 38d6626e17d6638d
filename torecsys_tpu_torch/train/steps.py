"""Train and eval step factories (counterpart of ``torecsys_tpu/train/steps.py``).

The train step dispatches on the state's optimizer layout, chosen at
:meth:`TrainState.create`, as the JAX package's does:

* the sparse (hybrid) step: forward with the sparse-route embeddings,
  ``loss.backward()`` (which leaves the dense gradients on the parameters
  and the per-slot table gradients on each embedding's lookup leaf), the
  dense optimizer's step, then the row-wise update of each table's touched rows,
  in place through the kernels: ``update_from_host_aux`` when the batch
  carries presort aux (the trusted presorted route), else the table
  module's id-sorted stream (``TableInput.sorted_slot_grads``, its own rule
  for the ids) and ``update_sorted`` (the on-device route);
* the dense step: forward, ``loss.backward()`` (the table gradient is the
  scatter-add of the lookup's backward), and one optimizer step over every
  parameter, the tables included.

The loss of each objective, as the JAX package's:

* ``ctr``: ``criterion(model(batch), batch[target])``;
* ``ltr``: the miner splits the batch into a positive and a negative view,
  the model is applied to each, in that order (a BatchNorm's statistics
  pass from the first application to the second), and the loss is
  ``criterion(pos (B, 1), negs (B, K))``, or, for a ``groupwise``
  criterion (ListNet), ``criterion(relevance, scores)`` over per-anchor
  ``[pos | negs]`` lists with one-hot relevance;
* ``emb``: the two views interleaved in per-anchor blocks ``[pos, negs]``
  (:func:`interleave_pos_neg`, the StarSpace layout), scored in one
  application, and ``criterion(scores[:, :1], scores[:, 1:])``;

plus the regularizer's penalty where the pipeline has one.  The miner's key
is :func:`miner_key` of the Trainer's seed and the state's step counter,
a device integer: the draws are device ops of the step, and a replay of a
captured step draws what the eager step draws.  ``ltr`` and ``emb`` train on
the dense route only; the sparse step refuses them, and a regularizer whose
filter matches a sparse table (its penalty's gradient cannot reach the
table there).

Under a mesh (``parallel``; the Trainer enters ``use_sharded_lookup``
around each step, so the tables' lookups take the collectives) a rank steps
on its data slice: its loss is the slice's mean over ``dp``, the data axis'
size, so that summed over the data group it is the global batch's mean; the
gradients of the replicated parameters (every parameter's on the dense
route, a sharded table's included, whose lookup backward fills only the
rank's rows) are summed over the data group, and the step's loss is the
data group's sum.  The ``ltr``/``emb`` miner draws from the global batch
(:func:`mine`), and a regularizer's penalty of a row-sharded table is the
whole table's in value (the table group's sum of the shards') and the
shard's in gradient.  On the sparse route each table's ids and per-slot
gradients are gathered over the data group in global batch order, so every
rank takes the global stream's unique rows and sums, as the JAX package's
step does; a row-sharded table's rank then updates its own rows
(``ops.sparse.sharded_row_update``).  Each table rank of a data slice runs
the same tower on the same slice, so the ranks stay equal without a
reduction over the table group.

Both steps run the model in ``train`` mode, where a BatchNorm normalizes
with the batch's statistics and moves its running statistics (the JAX
package's ``batch_stats``, here module buffers) in place, in eager steps
and in the captured graph alike.

:func:`make_train_scan` runs K consecutive train steps as one dispatch (the
JAX package's ``lax.scan`` of the step): on the card, a CUDA graph that
captures the K steps, replayed once per dispatch.

With the trainer's tracer on (``utils.trace``), a train step stamps the
card's clock at its stage edges: its start, the end of the forward pass (the
model and the loss), of the backward pass (with the data group's gradient
sum), of the dense optimizer and of the sparse update, and its end; a K-step
dispatch stamps around its group's copy.  A captured graph holds the stamps
it was captured with; with tracing off a mark does nothing.

The eval steps run the model in ``eval`` mode under ``torch.no_grad()``: a
BatchNorm normalizes with its running statistics.  The ranking eval step
(``ltr``/``emb``) mines with the key :func:`eval_miner_key` of the batch's
index and accumulates NDCG@k over the ``[pos | negs]`` lists.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Tuple

import torch

from torecsys_tpu_torch.convert import flax_path
from torecsys_tpu_torch.data.packed import BatchLayout
from torecsys_tpu_torch.miners import fold_in, seed_key
from torecsys_tpu_torch.parallel.mesh import DATA_AXIS, TABLE_AXIS
from torecsys_tpu_torch.parallel.sharding import _table_owners
from torecsys_tpu_torch.train.pipeline import Pipeline
from torecsys_tpu_torch.train.sparse import is_hybrid_opt_state, sparse_modules
from torecsys_tpu_torch.train.state import TrainState
from torecsys_tpu_torch.utils import trace

Batch = Dict[str, torch.Tensor]

# The stream constants the JAX package folds in: the step key from the state's
# key and the step, then 2 for the miner (1 is its dropout stream).
_STATE_STREAM = 1
_MINER_STREAM = 2


def miner_key(seed: int, step: torch.Tensor) -> torch.Tensor:
    """The train step's miner key: a 0-d int64 device tensor of the
    Trainer's ``seed`` and the state's ``step`` counter."""
    return fold_in(fold_in(fold_in(seed_key(seed), _STATE_STREAM), step.to(torch.int64)),
                   _MINER_STREAM)


def eval_miner_key(index: int) -> int:
    """The ranking evaluation's miner key of its ``index``-th batch, which
    does not depend on the seed (the JAX package's ``fold_in(PRNGKey(0),
    index)``)."""
    return fold_in(seed_key(0), index)


def interleave_pos_neg(pos: Batch, neg: Batch, num_negs: int) -> Batch:
    """The aggregated ``(B·(1+k), ...)`` batch of per-anchor blocks
    ``[pos_i, neg_i1, ..., neg_ik]``, the layout StarSpace-style models
    reshape on."""
    out = {}
    for name, p in pos.items():
        b, tail = p.shape[0], p.shape[1:]
        blocks = torch.cat([p.reshape(b, 1, *tail), neg[name].reshape(b, num_negs, *tail)], dim=1)
        out[name] = blocks.reshape(b * (1 + num_negs), *tail)
    return out


def ranking_lists(pos_out: torch.Tensor, neg_out: torch.Tensor,
                  num_negs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-anchor ``(B, 1 + k)`` score lists ``[pos | negs]`` and their one-hot
    relevance (1 for the positive)."""
    b = pos_out.shape[0]
    pos_s, neg_s = pos_out.reshape(b, 1), neg_out.reshape(b, num_negs)
    scores = torch.cat([pos_s, neg_s], dim=1)
    relevance = torch.cat([torch.ones_like(pos_s), torch.zeros_like(neg_s)], dim=1)
    return scores, relevance


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


def mine(pipeline: Pipeline, mesh, key, features: Batch) -> Tuple[Batch, Batch]:
    """The miner's ``(pos, neg)`` views of ``features``.  Under a split data
    axis the negatives' targets are drawn from the global batch, as the JAX
    package's miner draws them: the target field is gathered over the data
    group, and the rank takes its anchors' run of the global draws with the
    same key; the other fields stay local."""
    field = pipeline.miner_target_field
    dp = 1 if mesh is None else mesh.shape[DATA_AXIS]
    if dp == 1:
        return pipeline.miner(key, features, field)
    target = features[field]
    pool = mesh.all_gather(target, DATA_AXIS).reshape(-1, *target.shape[1:])
    return pipeline.miner(key, features, field, pool=pool, part=(mesh.index(DATA_AXIS), dp))


def reduce_gradients(mesh, params) -> None:
    """Sum the gradients of ``params`` over the data group, in place, one
    collective per dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        mesh.all_reduce(flat, DATA_AXIS)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def make_train_step(pipeline: Pipeline, seed: int = 0,
                    mesh=None) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict]]:
    """Build the train step ``(state, device batch) → (state, logs)``; the
    step updates the modules and ``state`` in place.  ``seed`` keys the
    miner of the ``ltr`` and ``emb`` objectives (:func:`miner_key`);
    ``mesh`` is the Trainer's (``parallel.mesh.Mesh``), None on one
    device."""
    dp = 1 if mesh is None else mesh.shape[DATA_AXIS]
    seq = pipeline.sequential
    criterion = pipeline.criterion
    regularizer = pipeline.regularizer
    objective = pipeline.objective
    modules = sparse_modules(seq)
    table_paths = {flax_path(path) for path in modules}  # as the JAX package names them
    # the row-sharded tables: the regularizer takes each one's whole penalty
    sharded = ({name for name, m in _table_owners(seq).items()
                if m.row_layout is not None and m.row_layout.sharded}
               if mesh is not None and mesh.shape[TABLE_AXIS] > 1 else set())

    def penalty() -> torch.Tensor:
        if not sharded:
            return regularizer(seq)
        return regularizer(seq, group_sum=lambda t: mesh.all_reduce(t, TABLE_AXIS),
                           sharded=sharded)

    def objective_loss(state: TrainState, batch: Batch) -> torch.Tensor:
        features, targets = _split_batch(batch, pipeline)
        if objective == "ctr":
            loss = criterion(seq(features), targets)
        else:
            k = pipeline.num_negs
            pos_b, neg_b = mine(pipeline, mesh, miner_key(seed, state.step), features)
            if objective == "emb":
                scores = seq(interleave_pos_neg(pos_b, neg_b, k)).reshape(-1, 1 + k)
                loss = criterion(scores[:, :1], scores[:, 1:])
            else:  # ltr
                pos_out = seq(pos_b)
                neg_out = seq(neg_b)
                if getattr(criterion, "groupwise", False):
                    scores, relevance = ranking_lists(pos_out, neg_out, k)
                    loss = criterion(relevance, scores)
                else:
                    b = pos_out.shape[0]
                    loss = criterion(pos_out.reshape(b, 1), neg_out.reshape(b, k))
        if regularizer is not None:
            loss = loss + penalty()
        return loss

    def rank_loss(state: TrainState, batch: Batch) -> torch.Tensor:
        """The loss this rank differentiates: its slice's over ``dp``."""
        loss = objective_loss(state, batch)
        return loss / dp if dp > 1 else loss

    def step_loss(loss: torch.Tensor) -> torch.Tensor:
        """The global batch's loss: the data group's sum of the ranks'."""
        loss = loss.detach()
        if dp > 1:
            loss = mesh.all_reduce(loss.clone(), DATA_AXIS)
        return loss

    def dense_train_step(state: TrainState, batch: Batch):
        trace.mark("step.begin")
        seq.train()
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        loss = rank_loss(state, batch)
        trace.mark("forward.end")
        loss.backward()
        if dp > 1:
            reduce_gradients(mesh, seq.parameters())
        trace.mark("backward.end")
        opt.step()
        trace.mark("dense_optimizer.end")
        out = _account(state, step_loss(loss))
        trace.mark("step.end")
        return out

    def check_sparse() -> None:
        if objective != "ctr":
            raise ValueError("sparse embedding optimization currently supports the 'ctr' "
                             f"objective only, got {objective!r}")
        key_filter = getattr(regularizer, "key_filter", "kernel")
        if regularizer is not None and any(key_filter in tp for tp in table_paths):
            raise ValueError(
                f"Regularizer(key_filter={regularizer.key_filter!r}) matches "
                f"sparse embedding tables {sorted(table_paths)}; their "
                "penalty gradient cannot flow on the touched-rows path. "
                "Use AdamW-style decoupled weight_decay (applied per touched "
                "row by the row optimizer) or set "
                "Pipeline.sparse_embeddings=False.")

    def sparse_train_step(state: TrainState, batch: Batch):
        check_sparse()
        row_tx = pipeline.row_optimizer()
        for module in modules.values():
            module.take_lookup()  # drop what a failed earlier step left
        trace.mark("step.begin")
        seq.train()
        dense_opt = state.opt_state["dense"]
        dense_opt.zero_grad(set_to_none=True)
        loss = rank_loss(state, batch)
        trace.mark("forward.end")
        loss.backward()
        if dp > 1:
            reduce_gradients(mesh, seq.parameters())
        trace.mark("backward.end")
        dense_opt.step()
        trace.mark("dense_optimizer.end")
        with torch.no_grad():
            for path, module in modules.items():
                lookup = module.take_lookup()
                if lookup is None:
                    raise RuntimeError(f"embedding {path!r} was not applied in the step")
                g = lookup.rows.grad
                if g is None:
                    g = torch.zeros_like(lookup.rows)
                ids = lookup.ids
                if dp > 1:  # the global stream, in global batch order
                    ids = mesh.all_gather(ids, DATA_AXIS).reshape(-1, *ids.shape[1:])
                    g = mesh.all_gather(g, DATA_AXIS).reshape(-1, *g.shape[1:])
                table, slots = module.table_view(), state.opt_state["sparse"][path]
                layout = module.row_layout
                if lookup.aux is not None:
                    row_tx.update_from_host_aux(table, slots, g.reshape(-1, g.shape[-1]), lookup.aux,
                                                state.step, layout=layout)
                    continue
                sorted_ids, g_sorted = module.sorted_slot_grads(ids, g)
                row_tx.update_sorted(table, slots, sorted_ids, g_sorted, state.step,
                                     layout=layout)
        trace.mark("sparse_update.end")
        out = _account(state, step_loss(loss))
        trace.mark("step.end")
        return out

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
    the CPU the K steps run eagerly in place of the graph, and so they do on
    the card with ``capture=False``: under a gloo mesh, whose collectives run
    on the host and cannot be captured (NCCL's can).
    """

    def __init__(self, train_step, seq: torch.nn.Module, k: int, layout: BatchLayout,
                 device: torch.device, capture: bool = True):
        self.train_step = train_step
        self.seq = seq
        self.k = k
        self.layout = layout
        self.device = device
        self.static = torch.empty((k, layout.nbytes), dtype=torch.uint8, device=device)
        self.losses = torch.zeros(k, dtype=torch.float32, device=device)
        self._batches = [layout.unpack(self.static[i]) for i in range(k)]
        capture = capture and device.type == "cuda"
        self._stream = torch.cuda.Stream(device) if capture else None
        self.graph = None
        self._held: Optional[List[int]] = None
        self.counted = collections.Counter()  # the tracer's host counts of the captured steps
        self.captures = 0
        self.replays = 0

    def _steps(self, state: TrainState) -> TrainState:
        for i, batch in enumerate(self._batches):
            trace.start_row(i)
            state, logs = self.train_step(state, batch)
            self.losses[i].copy_(logs["loss"])
        return state

    def _held_ptrs(self, state: TrainState) -> List[int]:
        return [t.data_ptr() for t in _held_tensors(self.seq, state)]

    def _capture(self, state: TrainState) -> None:
        self.graph = None  # its memory pool goes before the new capture
        graph = torch.cuda.CUDAGraph()
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with trace.recording() as counted, \
                torch.cuda.graph(graph, stream=self._stream, capture_error_mode="thread_local"):
            self._steps(state)
        self.counted = counted
        self.graph = graph
        self._held = self._held_ptrs(state)
        self.captures += 1

    def __call__(self, state: TrainState, packed: torch.Tensor) -> Tuple[TrainState, torch.Tensor]:
        """Take the K steps of ``packed``; returns the state (updated in
        place) and the ``(K,)`` float32 losses on the device."""
        if tuple(packed.shape) != (self.k, self.layout.nbytes):
            raise ValueError(f"packed group {tuple(packed.shape)} does not fit the scan's "
                             f"{(self.k, self.layout.nbytes)}")
        trace.mark("copy_in.begin")
        self.static.copy_(packed, non_blocking=True)
        trace.mark("copy_in.end")
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
        trace.replayed(self.counted)
        self.replays += 1
        return state, self.losses.clone()


def make_train_scan(train_step, seq: torch.nn.Module, k: int, layout: BatchLayout,
                    device: torch.device, capture: bool = True) -> TrainScan:
    """K steps of ``train_step`` per dispatch over packed groups of
    ``layout`` (:class:`TrainScan`)."""
    return TrainScan(train_step, seq, k, layout, device, capture)


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


def make_eval_ranking_step(pipeline: Pipeline, ndcg, mesh=None):
    """The ranking eval step of the ``ltr`` and ``emb`` objectives:
    ``(state, batch, index, ndcg_state) → ndcg_state``.  It mines each
    anchor's ``[pos | negs]`` list with :func:`eval_miner_key` of the
    batch's ``index`` (over the global batch under ``mesh``: :func:`mine`),
    scores the positive and the negative view (two applications, in eval
    mode) and accumulates NDCG@k with one-hot relevance on the device."""
    seq = pipeline.sequential

    def step(state: TrainState, batch: Batch, index: int, ndcg_state):
        del state  # the parameters live in the modules
        features, _ = _split_batch(batch, pipeline)
        pos_b, neg_b = mine(pipeline, mesh, eval_miner_key(index), features)
        seq.eval()
        with torch.no_grad():
            scores, relevance = ranking_lists(seq(pos_b), seq(neg_b), pipeline.num_negs)
            return ndcg.update(ndcg_state, scores, relevance)

    return step


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


__all__ = ["TrainScan", "eval_miner_key", "interleave_pos_neg", "make_eval_metrics_step",
           "make_eval_ranking_step", "make_eval_step", "make_train_scan", "make_train_step",
           "mine", "miner_key", "ranking_lists", "reduce_gradients"]
