"""Trainer: the fit / evaluate loop around the steps (counterpart of
``torecsys_tpu/train/trainer.py``).

The training loop's host input path, per group of ``steps_per_execution``
consecutive batches of one layout (``data.packed.group_batches``): on the
sparse route with the presort on, presort each batch's id streams
(``data.presort``, the C++ radix presort) and pack the group into one
buffer, pinned for the card (``data.packed``), in ``prefetch`` worker
threads; without a presort, pack the group on the loop's thread, where
worker threads would only contend with the loop for the interpreter lock;
then, on the loop's thread, copy the group to the card with one
non-blocking copy and
dispatch its steps: one replay of a CUDA graph of K steps
(``train.steps.make_train_scan``) for a full group of the captured layout,
else single eager steps.  The loop never waits on the device except where
it reads the loss or a metric.

The automatic dense/sparse choice (``set_sparse_embeddings(None)``) takes
the sparse route from a table size that depends on whether the presort
applies (:data:`SPARSE_AUTO_MIN_ELEMENTS`,
:data:`SPARSE_AUTO_MIN_ELEMENTS_PRESORTED`); a bf16 table keeps the dense
route.

Evaluation accumulates its metrics on the device and reads them once at
the end: streaming AUC and logloss for ``ctr``, and for ``ltr`` and ``emb``
mean NDCG@k (``ndcg_k``) over each held-out anchor's ``[pos | mined negs]``
list, mined with a key of the batch's index.  The ``ltr`` and ``emb``
objectives train on the dense route: the automatic choice never takes the
sparse one for them, and no presorter is built.

Checkpoints (``train.checkpoint``): with ``checkpoint_dir`` the trainer
writes ``ckpt_<step>.pt`` after each epoch, and :meth:`init_state`
restores ``load_from``, or else (``resume``) the newest checkpoint in
``checkpoint_dir``, in place into the fresh state.

Meshes (``parallel``): with ``mesh`` the trainer runs one rank of a
``(data, table)`` mesh of ranks, one device each.  The large embedding
tables are laid out row-sharded over ``table`` (``parallel.sharding``;
``lookup_options``' ``min_rows_to_shard`` feeds placement and lookup
routing alike), every other parameter replicated, and then the parameters
are drawn from ``seed`` on every rank alike: each table keeps the rank's
rows of the one-device draw; the dense optimizer takes its whole-parameter
reductions of a sharded table over the table group
(``train.optimizers``; an opaque factory's optimizer stays per shard, with a
warning); each rank keeps its data slice of every batch; the
steps, evaluation and prediction run inside ``use_sharded_lookup``, so the
lookups take the table group's collectives (``lookup_options``'
``strategy``: ``psum``, ``alltoall`` or ``auto``).  Evaluation and
prediction give the global batch's metrics and scores on every rank.  The
loss is checked for finiteness summed over every rank, so every rank takes
the same decision: under an all-to-all strategy a non-finite loss is taken
for a bucket overflow (:class:`LookupOverflowSuspected`) and, with
``lookup_recovery``, ``fit`` doubles the capacity factor up to the table
axis' size, then falls back to ``psum``, restarting the epoch from a fresh
state each time.  Checkpoints write each rank's shards beside one manifest
(``train.checkpoint``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from torecsys_tpu_torch.data.packed import BatchLayout, group_batches
from torecsys_tpu_torch.data.prefetch import prefetch_map
from torecsys_tpu_torch.data.presort import AUX_PREFIX, Presorter, build_presort_specs
from torecsys_tpu_torch.metrics import StreamingAUC, StreamingLogLoss, StreamingNDCG
from torecsys_tpu_torch.parallel.lookup import use_sharded_lookup
from torecsys_tpu_torch.parallel.mesh import DATA_AXIS, TABLE_AXIS, host_local_batch_to_global
from torecsys_tpu_torch.parallel.mesh import multi_node
from torecsys_tpu_torch.parallel.sharding import shard_batch, shard_module, unshard_module
from torecsys_tpu_torch.train.checkpoint import (
    checkpoint_name,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from torecsys_tpu_torch.train.optimizers import OptaxOptimizer
from torecsys_tpu_torch.train.pipeline import Pipeline
from torecsys_tpu_torch.train.sparse import is_hybrid_opt_state, sparse_modules
from torecsys_tpu_torch.train.state import TrainState
from torecsys_tpu_torch.train.steps import (
    TrainScan,
    make_eval_metrics_step,
    make_eval_ranking_step,
    make_eval_step,
    make_train_scan,
    make_train_step,
)
from torecsys_tpu_torch.utils import trace

logger = logging.getLogger(__name__)

# The automatic choice's thresholds, in elements of the packed tables
# (stored rows x stored width; 16 a logical row at E = 16): below them the
# dense route is taken.  Measured by
# ``chip_smoke.py --auto-sweep`` on an NVIDIA H100 80GB HBM3 at a 700.00 W
# power limit, in two runs: the dense route against each sparse route at
# 62.5k to 4M and to 16M logical rows (E = 16, the bench's field
# proportions, batch 4096, bf16 tower, 8 steps a dispatch, median of 3
# runs of 64 steps).  The on-device route beat the dense one at every size
# from 250k rows in both runs; at 125k it tied in one (4.884M examples/sec
# each) and won in the other, at 62.5k it lost in both (4.86-5.02M against
# 5.04-5.06M): 250k rows, 4,000,000 elements.  The presorted route waits
# on its host presort (1.17-1.56M examples/sec at every size) and beat the
# dense one from 8M rows on (1.35M against 0.98M; it lost at 4M,
# 1.33-1.41M against 1.64-1.66M): 8M rows, 128,000,000 elements.  So on this card the presort raises the crossover, where on
# the TPU v5e (the JAX package's) it lowers it.
SPARSE_AUTO_MIN_ELEMENTS = 4_000_000
SPARSE_AUTO_MIN_ELEMENTS_PRESORTED = 128_000_000


class LookupOverflowSuspected(RuntimeError):
    """A non-finite loss under an overflow-capable lookup strategy
    (``alltoall`` or ``auto``): the likely cause is a bucket of the
    all-to-all exchange over its static capacity, which poisons the lookup
    with NaN.  ``Trainer.fit`` recovers from it (:meth:`Trainer._recover_lookup`);
    it propagates only when recovery is off or out of moves."""


class _Group:
    """A packed group of host batches, ready to copy to the card."""

    def __init__(self, packed: torch.Tensor, layout: BatchLayout, n_examples: int):
        self.packed = packed
        self.layout = layout
        self.n_examples = n_examples

    def __len__(self) -> int:
        return self.packed.shape[0]


class Trainer:
    """Fits a :class:`Pipeline` on host-side batches (dicts of numpy arrays).

    Tracing, an operator's tool (``utils.trace``; off by default, no cost on
    the card when off): :meth:`set_tracing` ``(True)`` records the training
    loop's host stages (``wait``, ``presort``, ``pack``, ``place``,
    ``step``) and the train step's stages on the device (``step``,
    ``forward`` with ``lookup`` in it, ``backward``, ``dense_optimizer``,
    ``sparse_update``, and each dispatch's ``copy_in``), the device's from
    clock stamps that the K-step CUDA graph captures, mapped onto the host's
    ``perf_counter_ns``.  Switching drops the captured graph: the next
    dispatch captures it again.  :meth:`spans` returns the records kept since
    the last read; :meth:`trace_report` reduces them to ms a step: each
    device stage's self time (``span_ms``), the card's idle between
    dispatches (``gap_ms``) split by the host stage that overlapped it
    (``gap_by_host``), the clock mapping's uncertainty and the rings' drops.
    Reading synchronises with the card; recording does not.  ``host_ms``
    sums the host stages, on or off; and whenever a ``torch.profiler``
    records, each host stage is a ``torecsys.<stage>`` range in its trace
    (``profile_dir``'s too).

    Args:
        pipeline: a configured pipeline (``finalize`` is called here); the
            trainer runs on the pipeline's device.
        log_every: training-loss log cadence in steps (each log reads the
            loss on the host).
        seed: seed of the ``torch.Generator`` that :meth:`init_state` draws
            the parameters from, and of the ``ltr``/``emb`` miner's keys
            (``train.steps.miner_key``).
        presort: host-side id-stream preprocessing (``data.presort``) on the
            sparse route.  True presorts every training batch on the host,
            so the sparse step takes the trusted presorted route.  False
            builds no presorter: the batch carries no aux and the sparse
            step sorts and dedups on the device (the on-device route).  None
            (the default) presorts on the CPU, as the JAX package does on
            one host, and not on a CUDA card: there the device sort costs
            about 0.03 ms a step against the presort's milliseconds of a
            host core a batch, and every graphed sparse route waits on the
            host (``PERF.md`` §7).  The dense route builds no presorter
            either way.
        steps_per_execution: steps per dispatch K.  On the card a full group
            of K batches is one replay of a CUDA graph of K steps; an
            epoch's remainder of fewer than K batches, or a group whose
            batches' shapes differ from the captured ones, takes single
            eager steps.  On the CPU the K steps run eagerly.
        prefetch: look-ahead of the presort, in dispatches: up to
            ``prefetch`` groups are presorted and packed by ``min(4,
            prefetch)`` worker threads while the card runs earlier ones (the
            C++ presort releases the interpreter lock).  0, or a route
            without a presort, prepares each group on the loop's thread.
        profile_dir: where a ``torch.profiler`` trace
            (``trainer_trace.json``) of a few steps is written once: from
            the first dispatch that starts at step 4 or later through the
            dispatch that reaches step 8, or the next one (at least one
            dispatch), as the JAX package traces steps 4-8.
        checkpoint_dir: where a checkpoint ``ckpt_<step>.pt`` is written
            after each epoch (None: none is written).
        load_from: a checkpoint restored by :meth:`init_state` (default:
            the pipeline's ``load_from``); a missing file raises
            ``FileNotFoundError``.
        resume: with no ``load_from``, restore the newest checkpoint in
            ``checkpoint_dir`` if there is one (``load_from`` wins over it).
        ndcg_k: the cut-off of the ``ltr``/``emb`` evaluation's NDCG
            (None: the whole list).
        mesh: a ``parallel.make_mesh`` mesh; None = one device.  Every rank
            of the mesh runs its own Trainer over the same loaders: on one
            node each loader yields the global batch and the rank keeps its
            data slice (the batch must split evenly over ``data``); on
            several nodes each node's loader yields the node's share
            (``parallel.mesh.host_local_batch_to_global``).  The pipeline's
            device must be the mesh's.  Under a gloo mesh the K-step dispatch
            takes eager steps (gloo's collectives run on the host and cannot
            be captured in a CUDA graph); under NCCL it is captured.  The
            host presort does not run with a data axis above 1 or on several
            nodes (its aux describes the global batch).
        lookup_options: ``parallel.lookup.LookupContext`` keywords
            (``strategy``, ``capacity_factor``, ``min_rows_to_shard``); the
            same ``min_rows_to_shard`` places the tables.
        lookup_recovery: on a suspected all-to-all overflow, recover in
            ``fit`` (raise the capacity factor, then fall back to ``psum``)
            instead of raising :class:`LookupOverflowSuspected`.
    """

    def __init__(self, pipeline: Pipeline, log_every: int = 100, seed: int = 0,
                 presort: Optional[bool] = None, steps_per_execution: int = 1,
                 prefetch: int = 4, profile_dir: Optional[str] = None,
                 checkpoint_dir: Optional[str] = None, load_from: Optional[str] = None,
                 resume: bool = True, ndcg_k: Optional[int] = 10, mesh=None,
                 lookup_options: Optional[Dict] = None, lookup_recovery: bool = True):
        self.pipeline = pipeline.finalize()
        self.mesh = mesh
        self.lookup_options = dict(lookup_options or {})
        self.lookup_recovery = lookup_recovery
        if mesh is not None:
            if mesh.coordinate is None:
                raise ValueError(f"rank {mesh.rank} is outside the mesh {mesh.shape}")
            if mesh.device != pipeline.device:
                raise ValueError(f"the pipeline's device {pipeline.device} is not the mesh's "
                                 f"{mesh.device}")
        self.checkpoint_dir = checkpoint_dir
        self.load_from = load_from or self.pipeline.load_from
        self.resume = resume
        self.device = pipeline.device
        self.log_every = log_every
        self.seed = seed
        self.presort = presort
        self.steps_per_execution = max(1, int(steps_per_execution))
        self.prefetch = max(0, int(prefetch))
        self.profile_dir = profile_dir
        self.state: Optional[TrainState] = None
        self.history: List[Dict[str, float]] = []
        self.sparse: Optional[bool] = None
        self._presorter: Optional[Presorter] = None
        self._train_step_fn = None
        self._train_scan: Optional[TrainScan] = None
        self._eval_step_fn = None
        self._eval_metrics_fn = None
        self._auc = StreamingAUC()
        self._logloss = StreamingLogLoss()
        self.ndcg_k = ndcg_k
        self._ndcg = StreamingNDCG(k=ndcg_k)
        self._eval_ranking_fn = None
        self.tracer = trace.Tracer(self.device)
        self.recoveries: List[str] = []  # the lookup recovery's actions, in order

    # ---- setup ----------------------------------------------------------

    def _build_steps(self) -> None:
        self._train_step_fn = make_train_step(self.pipeline, self.seed, self.mesh)
        self._train_scan = None
        self._eval_step_fn = make_eval_step(self.pipeline)
        self._eval_metrics_fn = make_eval_metrics_step(self.pipeline, self._auc,
                                                       self._logloss)
        if self.pipeline.objective in ("ltr", "emb"):
            self._eval_ranking_fn = make_eval_ranking_step(self.pipeline, self._ndcg,
                                                           self.mesh)

    def _presort_applicable(self) -> bool:
        """Would the host presort run on the sparse route?  It also picks
        the automatic choice's threshold."""
        if self.mesh is not None and (self.mesh.shape[DATA_AXIS] > 1 or multi_node()):
            return False
        if self.presort is None:
            return self.device.type != "cuda"
        return bool(self.presort)

    def _choose_sparse(self, row_tx, modules) -> bool:
        """The route: sparse where the pipeline asks for it, else (None,
        the automatic choice) sparse from the threshold on, in table
        elements, of the presorted or the on-device route."""
        if row_tx is None or not modules:
            return False
        if self.pipeline.sparse_embeddings is not None:
            return True
        elements = sum(m.logical_rows() * m.embed_size for m in modules.values())
        threshold = (SPARSE_AUTO_MIN_ELEMENTS_PRESORTED if self._presort_applicable()
                     else SPARSE_AUTO_MIN_ELEMENTS)
        return elements >= threshold

    def init_state(self, example_batch: Optional[Dict[str, np.ndarray]] = None) -> TrainState:
        """Draw the parameters from ``seed``, choose the route and build its
        optimizer state, then restore ``load_from`` or, with ``resume``, the
        newest checkpoint in ``checkpoint_dir`` into it.  ``example_batch``
        is accepted for the JAX package's signature; torch modules know their
        shapes without one."""
        del example_batch
        seq = self.pipeline.sequential
        unshard_module(seq)
        layouts = {}
        if self.mesh is not None:  # laid out first: each rank draws its rows
            min_rows = self.lookup_options.get("min_rows_to_shard")
            rule = {} if min_rows is None else {"min_rows_to_shard": min_rows}
            layouts = shard_module(seq, self.mesh, **rule)
        seq.reset_parameters(torch.Generator(device=self.device).manual_seed(self.seed))
        row_tx = self.pipeline.row_optimizer()
        modules = sparse_modules(seq)
        self.sparse = self._choose_sparse(row_tx, modules)
        for module in modules.values():
            module.sparse_grads = self.sparse
        self.state = TrainState.create(seq, self.pipeline.optimizer,
                                       row_tx if self.sparse else None,
                                       set(modules) if self.sparse else None, self.device)
        if layouts:
            self._reduce_over_tables(layouts)
        self._presorter = (Presorter(build_presort_specs(self.pipeline.inputs))
                           if self.sparse and self._presort_applicable() else None)
        self._build_steps()
        self._maybe_restore()
        return self.state

    def _reduce_over_tables(self, layouts) -> None:
        """Give the dense optimizer the row-sharded tables it holds (on the
        dense route, or a sequence table), so that its whole-parameter norms,
        means and maxima run over the logical table
        (``OptaxOptimizer.reduce_over``).  An opaque factory's optimizer
        cannot be reduced for: it stays per shard, with a warning naming
        each such table."""
        opt = self.state.opt_state
        dense = opt["dense"] if is_hybrid_opt_state(opt) else opt
        held = {id(p) for group in dense.param_groups for p in group["params"]}
        named = dict(self.pipeline.sequential.named_parameters())
        tables = {name: layout for name, layout in layouts.items()
                  if layout.sharded and id(named[name]) in held}
        if not tables:
            return
        if self.pipeline.optimizer_spec is None:
            logger.warning("the opaque optimizer factory's %s updates each rank's shard of the "
                           "row-sharded tables %s on its own: any norm, mean or maximum it "
                           "takes over a parameter is the shard's, not the table's",
                           type(dense).__name__, sorted(tables))
        elif isinstance(dense, OptaxOptimizer):
            dense.reduce_over(self.mesh, {named[name]: layout
                                          for name, layout in tables.items()})

    def _maybe_restore(self) -> None:
        """Restore ``load_from`` (explicit) or the newest checkpoint in
        ``checkpoint_dir`` (auto-resume) into the state, in place."""
        path = self.load_from
        if path is None and self.resume and self.checkpoint_dir:
            path = latest_checkpoint(self.checkpoint_dir)
        if path is None:
            return
        if not os.path.exists(path):
            raise FileNotFoundError(f"load_from checkpoint not found: {path}")
        restore_checkpoint(path, self.pipeline.sequential, self.state)

    def save_checkpoint(self, path: Optional[str] = None) -> str:
        """Write the state to ``path`` (default: ``ckpt_<step>.pt`` in
        ``checkpoint_dir``); returns the path."""
        if path is None:
            if not self.checkpoint_dir:
                raise ValueError("save_checkpoint needs a path or the trainer's checkpoint_dir")
            path = os.path.join(self.checkpoint_dir, checkpoint_name(int(self.state.step)))
        return save_checkpoint(path, self.pipeline.sequential, self.state, mesh=self.mesh)

    def _lookup_scope(self):
        """The sharded lookups' context under the mesh (entered around every
        step, evaluation and prediction), else nothing."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return use_sharded_lookup(self.mesh, **self.lookup_options)

    def _local_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """This rank's part of a loader's batch (the batch itself without a
        mesh)."""
        if self.mesh is None:
            return batch
        if multi_node():
            return host_local_batch_to_global(batch, self.mesh)
        return shard_batch(batch, self.mesh)

    def _place_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host batch → this rank's part on the device (the evaluation's
        path)."""
        batch = self._local_batch(batch)
        placed = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory()
            placed[k] = t.to(self.device, non_blocking=True)
        return placed

    # ---- the training input path ----------------------------------------

    @property
    def host_ms(self) -> Dict[str, float]:
        """Host wall ms of the training input path by stage, summed over
        steps (the tracer's host spans, on or off): ``presort`` and ``pack``
        (pinning included), in the workers or on the loop's thread; on the
        loop's thread ``wait`` for a prepared group (which takes in the
        presort and pack where they run there), ``place``, the copy of each
        eager step's batch to the card, and ``step``, the steps' enqueue or
        the graph's copy and replay; the steps run on after their enqueue
        returns."""
        return self.tracer.host_ms

    @host_ms.setter
    def host_ms(self, value: Dict[str, float]) -> None:
        self.tracer.host_ms = value

    def _prepare(self, group: List[Dict[str, np.ndarray]],
                 at: Optional[Tuple[int, int]] = None) -> _Group:
        """The input path's transform, in a worker or on the loop's thread:
        presort each batch (where the presort runs), then pack the group into
        one buffer, pinned where the card reads it.  ``at`` is the group's
        ``(dispatch, first step)`` for its spans."""
        n_examples = sum(next(np.shape(v)[0] for k, v in b.items()
                              if not k.startswith(AUX_PREFIX)) for b in group)
        group = [self._local_batch(b) for b in group]
        if self._presorter is not None:
            with self.tracer.span("presort", at):
                group = [self._presorter(b) for b in group]
        with self.tracer.span("pack", at):
            layout = BatchLayout.of(group[0])
            packed = layout.pack(group, pin=self.device.type == "cuda")
        return _Group(packed, layout, n_examples)

    def _prepared(self, batches: Iterable[Dict[str, np.ndarray]]) -> Iterator[_Group]:
        groups = self.tracer.numbered(group_batches(batches, self.steps_per_execution))
        workers = min(4, self.prefetch) if self._presorter is not None else 0
        return prefetch_map(groups, lambda item: self._prepare(*item), num_workers=workers,
                            depth=self.prefetch)

    def _dispatch(self, group: _Group) -> List[torch.Tensor]:
        """Take the steps of one packed group; returns their losses as 0-d
        device tensors."""
        with self._lookup_scope(), self.tracer.active():
            return self._dispatch_steps(group)

    def _dispatch_steps(self, group: _Group) -> List[torch.Tensor]:
        tracer = self.tracer
        k = self.steps_per_execution
        tracer.begin_dispatch()
        if k > 1 and len(group) == k:
            if self._train_scan is None:
                capture = self.mesh is None or self.mesh.backend != "gloo"
                self._train_scan = make_train_scan(self._train_step_fn,
                                                   self.pipeline.sequential, k, group.layout,
                                                   self.device, capture)
            if self._train_scan.layout == group.layout:
                with tracer.span("step"):
                    self.state, losses = self._train_scan(self.state, group.packed)
                tracer.end_dispatch(k)
                self.state.loss_count += k
                return list(losses.unbind(0))
        losses = []
        for i, row in enumerate(group.packed):
            with tracer.span("place"):
                if self.device.type == "cuda":
                    row = row.to(self.device, non_blocking=True)
                placed = group.layout.unpack(row)
            trace.start_row(i)
            with tracer.span("step"):
                self.state, logs = self._train_step_fn(self.state, placed)
            self.state.loss_count += 1
            losses.append(logs["loss"])
        tracer.end_dispatch(len(losses))
        return losses

    def _dispatches(self, batches: Iterable[Dict[str, np.ndarray]]
                    ) -> Iterator[Tuple[int, List[torch.Tensor]]]:
        """(examples, per-step losses) of each dispatch over ``batches``."""
        if self.state is None:
            self.init_state()
        prepared = self._prepared(batches)
        try:
            while True:
                with self.tracer.span("wait"):
                    group = next(prepared, None)
                if group is None:
                    return
                yield group.n_examples, self._dispatch(group)
        finally:
            prepared.close()

    # ---- tracing --------------------------------------------------------

    def set_tracing(self, enabled: bool) -> None:
        """Switch the tracer's span records on or off (off at first; see
        the class docstring).  Either switch drops the captured K-step graph,
        so the next dispatch captures it again, with the stamps or without
        them."""
        if bool(enabled) == self.tracer.enabled:
            return
        if enabled:
            self.tracer.enable(self.steps_per_execution)
        else:
            self.tracer.disable()
        if self._train_scan is not None:
            self._train_scan.graph = None

    def spans(self) -> List[trace.Span]:
        """The spans recorded since the last read, sorted by start
        (``utils.trace.Span``), forgotten once read."""
        return self.tracer.drain()

    def trace_report(self) -> Dict:
        """The spans recorded since the last read, reduced to ms a step
        (``utils.trace.reduce``), with the clock's uncertainty and the
        rings' drops; forgotten once read."""
        return self.tracer.report()

    # ---- training -------------------------------------------------------

    def train_steps(self, batches: Iterable[Dict[str, np.ndarray]]) -> List[torch.Tensor]:
        """Train on each host batch through the input path and the
        dispatches; returns the per-step losses as 0-d device tensors
        (nothing is read back here)."""
        return [loss for _, losses in self._dispatches(batches) for loss in losses]

    @property
    def graph_stats(self) -> Dict[str, int]:
        """CUDA graph captures and replays of the K-step dispatch so far."""
        scan = self._train_scan
        return {"captures": scan.captures if scan else 0, "replays": scan.replays if scan else 0}

    def _mean_loss(self) -> float:
        """The mean training loss; under a mesh NaN when any rank's is not
        finite (the check sums it over every rank, so that every rank takes
        the same decision)."""
        mean = self.state.mean_loss()
        if self.mesh is not None and not torch.isfinite(
                self.mesh.world_all_reduce(mean.reshape(1).clone())).all():
            return float("nan")
        return float(mean)

    def _check_finite_loss(self, loss_sum: float, step: int) -> None:
        """Raise on a non-finite loss: :class:`LookupOverflowSuspected`,
        naming the capacity factor, under a mesh whose lookup strategy can
        overflow; else ``RuntimeError``."""
        if np.isfinite(loss_sum):
            return
        msg = f"non-finite training loss at step {step}"
        strategy = self.lookup_options.get("strategy", "psum")
        if self.mesh is not None and strategy in ("alltoall", "auto"):
            cf = self.lookup_options.get("capacity_factor", 2.0)
            raise LookupOverflowSuspected(
                f"{msg} — the lookup strategy is {strategy!r}: a likely cause is an all-to-all "
                "bucket-capacity overflow (ids concentrated on one table shard); raise "
                f"lookup_options['capacity_factor'] (currently {cf}, worst-case-safe is the "
                "table-axis size) or set lookup_options['strategy']='psum'")
        raise RuntimeError(f"{msg} (diverged training or bad input data)")

    def _recover_lookup(self) -> Optional[str]:
        """Adjust the lookup options after a suspected bucket overflow:
        double ``capacity_factor`` up to the table axis' size, then fall back
        to ``psum`` (which cannot overflow).  Returns the action taken, or
        None when out of moves."""
        ts = self.mesh.shape.get(TABLE_AXIS, 1) if self.mesh is not None else 1
        cf = float(self.lookup_options.get("capacity_factor", 2.0))
        if self.lookup_options.get("strategy") == "psum":
            return None
        if cf < ts:
            new_cf = min(cf * 2.0, float(ts))
            self.lookup_options["capacity_factor"] = new_cf
            return f"capacity_factor {cf} -> {new_cf}"
        self.lookup_options["strategy"] = "psum"
        return f"strategy -> 'psum' (capacity_factor {cf} already >= table axis {ts})"

    def fit(self, train_loader: Iterable[Dict[str, np.ndarray]],
            val_loader: Optional[Iterable[Dict[str, np.ndarray]]] = None,
            max_epochs: int = 1, max_steps: Optional[int] = None) -> Dict[str, float]:
        """Run the training loop; returns the last epoch's metrics, with
        the metrics of :meth:`evaluate` after each
        epoch when ``val_loader`` is given.

        ``train_loader`` and ``val_loader`` may be re-iterable containers or
        zero-arg callables returning a fresh iterator per epoch.  With
        ``max_steps`` the loop stops after the dispatch that reaches it (up
        to K - 1 steps past it), as the JAX package's does.
        """
        if self.state is None:
            self.init_state()
        metrics: Dict[str, float] = {}
        step = 0
        epoch = 0
        while epoch < max_epochs:
            epoch_start_step = step
            try:
                metrics, step = self._fit_epoch(epoch, step, train_loader, val_loader,
                                                max_steps)
            except LookupOverflowSuspected as e:
                # The NaN poisoned the state: adjust the lookup options, start
                # from a fresh state (which resumes from the newest checkpoint
                # when there is one), rebuild the steps and graphs, and rerun
                # this epoch.  The escalation ends (capacity up to the table
                # axis, then psum, then None).
                action = self._recover_lookup() if self.lookup_recovery else None
                if action is None:
                    raise
                logger.warning("suspected all-to-all overflow (%s); recovering: %s; "
                               "restarting epoch %d", e, action, epoch)
                self.recoveries.append(action)
                self.state = None
                self._presorter = None
                self._train_scan = None
                self.init_state()
                step = epoch_start_step
                continue
            epoch += 1
            if max_steps is not None and step >= max_steps:
                break
        return metrics

    def _fit_epoch(self, epoch: int, step: int, train_loader, val_loader,
                   max_steps: Optional[int]):
        """One epoch of :meth:`fit`; returns its metrics and the step count."""
        profiler = None
        t0 = time.perf_counter()
        n_examples = 0
        self.state.reset_metrics()
        dispatches = self._dispatches(self._epoch_iter(train_loader))
        try:
            for examples, losses in dispatches:
                n_examples += examples
                step += len(losses)
                if profiler is not None and step >= 8:
                    profiler = self._stop_profile(profiler)
                if step % self.log_every == 0:
                    mean = self._mean_loss()
                    self._check_finite_loss(mean, step)
                    logger.info("epoch %d step %d loss %.5f", epoch, step, mean)
                if max_steps is not None and step >= max_steps:
                    break
                if self.profile_dir and profiler is None and step >= 4:
                    profiler = self._start_profile()
        finally:
            dispatches.close()
            if profiler is not None:
                profiler = self._stop_profile(profiler)
        mean = self._mean_loss()  # waits for the device
        self._check_finite_loss(mean, step)
        elapsed = max(time.perf_counter() - t0, 1e-9)
        metrics = {"epoch": epoch, "train_loss": mean,
                   "examples_per_sec": n_examples / elapsed}
        if val_loader is not None:
            metrics.update(self.evaluate(val_loader))
        logger.info("epoch %d done: %s", epoch, metrics)
        self.history.append(metrics)
        if self.checkpoint_dir:
            self.save_checkpoint()
        return metrics, step

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profile(self, profiler) -> None:
        """Stop the trace, write it to ``profile_dir`` once and clear it."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(self.profile_dir, "trainer_trace.json"))
        self.profile_dir = None
        return None

    @staticmethod
    def _epoch_iter(loader):
        return iter(loader() if callable(loader) else loader)

    # ---- evaluation -----------------------------------------------------

    def evaluate(self, loader: Iterable[Dict[str, np.ndarray]]) -> Dict[str, float]:
        """Streaming metrics over a validation loader; the metric states stay
        on the device until the end.  ``ctr``: AUC and logloss on the target
        field.  ``ltr``/``emb``: ``val_ndcg@k`` (:meth:`_evaluate_ranking`)."""
        if self.state is None:
            raise RuntimeError("call fit() or init_state() before evaluate()")
        if self.pipeline.objective in ("ltr", "emb"):
            return self._evaluate_ranking(loader)
        target = self.pipeline.target_fields
        auc_state = self._auc.init(self.device)
        ll_state = self._logloss.init(self.device)
        with self._lookup_scope():
            for batch in self._epoch_iter(loader):
                if target not in batch:
                    raise ValueError(f"evaluation batch is missing the target field "
                                     f"{target!r} (fields: {sorted(batch)})")
                auc_state, ll_state = self._eval_metrics_fn(
                    self.state, self._place_batch(batch), auc_state, ll_state)
        auc_state, ll_state = self._merged(auc_state), self._merged(ll_state)
        return {"val_auc": float(self._auc.compute(auc_state)),
                "val_logloss": float(self._logloss.compute(ll_state))}

    def _evaluate_ranking(self, loader) -> Dict[str, float]:
        """Mean NDCG@k over each anchor's ``[pos | mined negs]`` list, the
        ``i``-th batch mined with the key of ``i``
        (``train.steps.eval_miner_key``), so every evaluation of one loader
        draws the same lists."""
        state = self._ndcg.init(self.device)
        with self._lookup_scope():
            for i, batch in enumerate(self._epoch_iter(loader)):
                state = self._eval_ranking_fn(self.state, self._place_batch(batch), i, state)
        key = f"val_ndcg@{self.ndcg_k}" if self.ndcg_k else "val_ndcg"
        return {key: float(self._ndcg.compute(self._merged(state)))}

    def _merged(self, metric_state):
        """A streaming metric's state summed over the data group (its merge),
        so that every rank computes the global metric."""
        if self.mesh is None or self.mesh.shape[DATA_AXIS] == 1:
            return metric_state
        return type(metric_state)(*(self.mesh.all_reduce(t.clone(), DATA_AXIS)
                                    for t in metric_state))

    def predict(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        """The eval step's scores of one host batch, on the device:
        probabilities, ``(B, 1)`` float32, or ``(B, T)`` for a multi-task
        model, or the tuple of a model with several probability outputs
        (ESMM); as in the JAX package, a tuple of raw scores cannot take
        the sigmoid and raises."""
        if self.state is None:
            raise RuntimeError("call fit() or init_state() before predict()")
        with self._lookup_scope():
            preds, _ = self._eval_step_fn(self.state, self._place_batch(batch))
        if self.mesh is None or self.mesh.shape[DATA_AXIS] == 1:
            return preds

        def gathered(t):  # the data group's slices, in global batch order
            return self.mesh.all_gather(t, DATA_AXIS).reshape(-1, *t.shape[1:])

        return tuple(map(gathered, preds)) if isinstance(preds, tuple) else gathered(preds)


__all__ = ["LookupOverflowSuspected", "SPARSE_AUTO_MIN_ELEMENTS",
           "SPARSE_AUTO_MIN_ELEMENTS_PRESORTED", "Trainer"]
