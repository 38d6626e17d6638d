"""Touched-rows-only embedding updates: dedup and lazy row-wise optimizers.

Counterpart of ``torecsys_tpu/ops/sparse.py``.  The train step never builds a
dense ``(V, E)`` table gradient: the embedding module hands out its
looked-up rows as a leaf tensor, autograd fills in the per-slot gradient
``(B, N, E)``, and :class:`RowAdam`, :class:`RowAdagrad` or :class:`RowSGD`
applies its rule to just the stored rows the batch touched.  Two routes:

* the trusted presorted route (:meth:`~_RowOptimizerBase.update_from_host_aux`):
  the host presort (``data.presort``) supplies the sort order, in-row slots,
  segment ids, compact unique stored-row ids and their count (placed on the
  card), so the device permutes the narrow ``(M, E)`` grads (the
  ``row_gather`` kernel), sums them per stored row widened to ``(M, P*E)`` (:func:`_sorted_gsum`: the
  ``widen_segment_sum`` kernel, or ``segment_sum_wide`` at ``P == 1``) and
  updates the unique rows in place (the ``fused_rowwise_update`` kernel);
* the on-device route (:meth:`~_RowOptimizerBase.update_sorted`), for a
  batch without presort aux: the step sorts the ids on the card
  (:func:`sort_slot_grads`, a stable ``torch.sort``, then the grads'
  permute by the ``row_gather`` kernel), then either combines
  them (:func:`_combine_sorted_stored`: segment ids by prefix sum, unique
  stored rows by scatter, the wide sums by :func:`_sorted_gsum`) and
  updates with ``fused_rowwise_update``, its unique count a device tensor;
  or, with ``TORECSYS_TPU_FUSED_DEDUP=1``, does all of it in one
  ``fused_sorted_dedup_update`` kernel.

:func:`dedup_sum`, :func:`dedup_sum_stored` and :func:`dedup_sum_fields` are
the reference contracts of the dedup, as in the JAX package.

A row-sharded table (``parallel.sharding``) takes both routes up to the
unique rows, on the global id stream, then :func:`sharded_row_update`: each
table rank maps the rows it owns to its shard's ids, the others to a
sentinel, and updates them with the same ``fused_rowwise_update``.  Under
a mesh whose table axis is split the
on-device route does not take the one-pass ``fused_sorted_dedup_update``
even when ``TORECSYS_TPU_FUSED_DEDUP=1`` asks for it: it combines and
updates as by default, as the JAX package's kernel gate yields there.

Semantics are those of the JAX package: lazy optimizers (rows absent from a
batch keep their slots), Adam's global-step bias correction, decoupled
weight decay, and stored-row granularity (a logical row sharing a stored row
with a touched one sees a zero gradient).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import torch

from torecsys_tpu_torch.ops.kernels import embedding as KE
from torecsys_tpu_torch.ops.kernels import sparse_update as K
from torecsys_tpu_torch.utils import trace

FUSED_DEDUP_ENV = "TORECSYS_TPU_FUSED_DEDUP"


def fused_dedup_enabled() -> bool:
    """The JAX package's switch of the on-device route, read at call time:
    ``TORECSYS_TPU_FUSED_DEDUP`` in ("1", "true", "on") selects the one-pass
    ``fused_sorted_dedup_update``."""
    return os.environ.get(FUSED_DEDUP_ENV, "0") in ("1", "true", "on")


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D tensor, in its own dtype.

    The JAX package's two-level form exists only because XLA compiles a long
    ``cumsum`` badly on a TPU; here it is one ``torch.cumsum``.
    """
    return torch.cumsum(x, 0, dtype=x.dtype)


def _segments(sorted_keys: torch.Tensor) -> torch.Tensor:
    """int32 segment id of each position of a nondecreasing key stream,
    dense from 0."""
    is_first = torch.ones_like(sorted_keys, dtype=torch.bool)
    is_first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    return prefix_sum(is_first.to(torch.int32)) - 1


def _widen(grads: torch.Tensor, lo: torch.Tensor, pack: int) -> torch.Tensor:
    """``(M, E)`` narrow rows placed into their in-row slot of ``(M, P*E)``."""
    m, e = grads.shape
    wide = grads.new_zeros(m, pack, e)
    wide[torch.arange(m, device=grads.device), lo.long()] = grads
    return wide.reshape(m, pack * e)


def dedup_sum(ids: torch.Tensor, grads: torch.Tensor, num_rows: int):
    """Combine duplicate-id gradients: ``(M,) ids, (M, E) grads → (M,), (M, E)``.

    Slot ``k < n_unique`` holds the k-th unique id (ascending) and the sum of
    its occurrences' gradients in position order; slots ``k >= n_unique``
    hold the sentinel ``num_rows`` and a zero gradient.
    """
    m = ids.shape[0]
    sorted_ids, order = torch.sort(ids.to(torch.int32), stable=True)
    g_sorted = grads.index_select(0, order)
    seg = _segments(sorted_ids).long()
    gsum = torch.zeros_like(g_sorted).index_add_(0, seg, g_sorted)
    uids = torch.full((m,), num_rows, dtype=torch.int32, device=ids.device)
    return uids.scatter_(0, seg, sorted_ids), gsum


def dedup_sum_stored(ids: torch.Tensor, grads: torch.Tensor, pack: int,
                     num_stored_rows: int):
    """Stored-row-space dedup: ``(M,) logical ids, (M, E) grads → (M,)
    unique stored-row ids, (M, P*E) wide summed grads``: each grad is placed
    into its in-row slot (``id % P``) and summed per stored row
    (``id // P``)."""
    if pack == 1:
        return dedup_sum(ids, grads, num_stored_rows)
    ids = ids.to(torch.int32)
    return dedup_sum(ids // pack, _widen(grads, ids % pack, pack), num_stored_rows)


def sort_slot_grads(ids: torch.Tensor, grads: torch.Tensor):
    """Sort per-slot grads by id: ``(B, K) ids, (B, K, E) grads → (M,)
    sorted int32 ids, (M, E) permuted grads``.

    The sort is stable, as ``jax.lax.sort_key_val`` is: equal ids keep their
    slot order, which is the order their grads are summed in, so the sums
    agree with the presorted route (a stable numpy argsort) to the bit.
    """
    e = grads.shape[-1]
    flat_ids = ids.reshape(-1).to(torch.int32)
    sorted_ids, order = torch.sort(flat_ids, stable=True)
    return sorted_ids, KE.row_gather(grads.reshape(-1, e).contiguous(), order)


def sort_bag_grads(ids: torch.Tensor, bag_grads: torch.Tensor, bags: torch.Tensor):
    """Sort a multi-hot lookup's slots by id, each slot taking its bag's
    gradient: ``(B, S) ids, (B, N, E) bag grads, (S,) bag of each slot →
    (M,) sorted int32 ids, (M, E) grads``, ``M = B*S``.  The same as
    :func:`sort_slot_grads` of the ``(B, S, E)`` slot grads
    ``bag_grads[:, bags]``, which are never formed: one ``row_gather``
    reads each sorted slot's bag row."""
    b, s = ids.shape
    n, e = bag_grads.shape[1], bag_grads.shape[2]
    sorted_ids, order = torch.sort(ids.reshape(-1).to(torch.int32), stable=True)
    src = torch.div(order, s, rounding_mode="floor") * n + bags[order % s]
    return sorted_ids, KE.row_gather(bag_grads.reshape(-1, e).contiguous(), src)


def _combine_sorted_stored(sorted_ids: torch.Tensor, g_sorted: torch.Tensor, pack: int,
                           num_stored_rows: int):
    """An id-ascending ``(M,)`` stream and its ``(M, E)`` grads → compact
    ``(M,)`` unique stored-row ids (sentinel ``num_stored_rows`` past the
    last), ``(M, P*E)`` wide summed grads, and (the port's addition) their
    count, a 0-d int32 tensor on the stream's device: nothing is read back."""
    sorted_ids = sorted_ids.to(torch.int32)
    hi = sorted_ids // pack
    seg = _segments(hi)
    # Every writer of uids[s] writes the same value (hi is constant within a
    # segment), so the scatter is deterministic whatever its order.
    uids = torch.full_like(hi, num_stored_rows).scatter_(0, seg.long(), hi)
    gsum = _sorted_gsum(g_sorted, sorted_ids % pack, seg, pack)
    return uids, gsum, seg[-1] + 1


def dedup_sum_fields(ids: torch.Tensor, grads: torch.Tensor, pack: int,
                     num_stored_rows: int):
    """Dedup per-slot gradients into stored-row space: ``(B, K) ids,
    (B, K, E) grads → (B*K,) unique stored-row ids, (B*K, P*E) wide sums``:
    :func:`sort_slot_grads` then :func:`_combine_sorted_stored`."""
    sorted_ids, g_sorted = sort_slot_grads(ids, grads)
    uids, gsum, _ = _combine_sorted_stored(sorted_ids, g_sorted, pack, num_stored_rows)
    return uids, gsum


def _sorted_gsum(g_sorted: torch.Tensor, lo: torch.Tensor, seg: torch.Tensor,
                 pack: int) -> torch.Tensor:
    """Segment-sum a sorted NARROW grad stream into wide stored-row sums.

    ``pack == 1`` (E >= 128 after packing) has no widen to do and takes the
    ``segment_sum_wide`` kernel; every other pack ``widen_segment_sum``.
    """
    if pack == 1:
        return K.segment_sum_wide(g_sorted, seg)
    return K.widen_segment_sum(g_sorted, lo, seg, pack)


def _table_axis_split() -> bool:
    """Whether a sharded lookup context whose table axis is split is
    active (the JAX package's ``_sharded_update_ctx() is not None``)."""
    from torecsys_tpu_torch.parallel import lookup as _lookup

    ctx = _lookup._context()
    return ctx is not None and ctx.mesh.shape.get(ctx.table_axis, 1) > 1


def sharded_row_update(row_tx, table: torch.Tensor, slots: Dict[str, torch.Tensor],
                       uids: torch.Tensor, gsum: torch.Tensor, step: torch.Tensor, layout,
                       n_valid=None):
    """Apply a row-wise optimizer to this table rank's shard of a
    row-sharded table, in place.

    ``uids``/``gsum`` are the global ascending unique stored rows (the
    sentinel ``layout.rows`` past the last) and their summed gradients, the
    same on every rank; ``n_valid`` their count (a host int, a 0-d int32
    device tensor, or None: every row).  Each uid the rank owns becomes its
    shard-local id, every other the sentinel ``local_rows``, in place in the
    stream, and ``row_tx.update`` (the ``fused_rowwise_update`` kernel)
    updates the rank's table and slots with them, skipping the sentinels:
    the same state as the update of the whole table, row by row.  Nothing
    is moved: the summed gradients stay where they are.
    """
    r = uids.to(torch.int64)
    mine = layout.served(r)
    local_u = torch.where(mine, layout.local(r), layout.local_rows).to(torch.int32)
    trace.count_device("touched_rows", mine.sum(dtype=torch.int32))
    return row_tx.update(table, slots, local_u, gsum, step, n_valid=n_valid)


def _hyper(step: torch.Tensor, *values) -> torch.Tensor:
    """The ``(7,)`` float32 hyperparameter vector on ``step``'s device, from
    floats or 0-d tensors; nothing is read back.  A schedule as the learning
    rate raises ``TypeError``, as the JAX package's row optimizers take
    ``jnp.float32(learning_rate)`` at the first sparse step."""
    if callable(values[0]):
        raise TypeError(f"a schedule {values[0]!r} as learning_rate has no row-wise form: the "
                        "row optimizers take a float (use the dense route)")
    return torch.stack([v if isinstance(v, torch.Tensor)
                        else torch.full((), v, dtype=torch.float32, device=step.device)
                        for v in values])


class _RowOptimizerBase:
    """What the row-wise optimizers share: the in-place update of unique
    rows through ``fused_rowwise_update``, and its two routes.

    The port updates the table and slots where they lie (both are mutable);
    each method also returns them, as the JAX package returns new arrays.
    """

    def hyper_and_rule(self, step: torch.Tensor):
        raise NotImplementedError

    def _slot_tuple(self, slots: Dict[str, torch.Tensor], w: int):
        """The slot tensors in the kernels' layout (views, no copies)."""
        return ()

    def update(self, table: torch.Tensor, slots: Dict[str, torch.Tensor],
               uids: torch.Tensor, gsum: torch.Tensor, step: torch.Tensor,
               n_valid=None):
        """Update the unique rows ``uids`` in place; ``n_valid`` is a host
        int, a 0-d int32 device tensor or None (see ``fused_rowwise_update``)."""
        w = gsum.shape[-1]
        hyper, rule = self.hyper_and_rule(step)
        K.fused_rowwise_update(uids, gsum, table.reshape(-1, w), self._slot_tuple(slots, w),
                               hyper, rule, n_valid)
        return table, slots

    def update_sorted(self, table: torch.Tensor, slots: Dict[str, torch.Tensor],
                      sorted_ids: torch.Tensor, g_sorted: torch.Tensor, step: torch.Tensor,
                      layout=None):
        """On-device route, in place: an ascending ``(M,)`` logical id stream
        and its ``(M, E)`` grads (:func:`sort_slot_grads`).

        The JAX package's switch selects the kernels: with
        ``TORECSYS_TPU_FUSED_DEDUP=1`` one ``fused_sorted_dedup_update``
        (not under a split table axis); otherwise the combine
        (``widen_segment_sum`` or ``segment_sum_wide``) and
        ``fused_rowwise_update``, whose unique count stays on the device.
        With ``layout`` the table is this rank's shard of a row-sharded
        table and the stream the global one (:func:`sharded_row_update`).
        """
        e = g_sorted.shape[-1]
        w = table.shape[-1]
        pack = w // e
        tbl = table.reshape(-1, w)
        if fused_dedup_enabled() and layout is None and not _table_axis_split():
            hyper, rule = self.hyper_and_rule(step)
            K.fused_sorted_dedup_update(sorted_ids, g_sorted, tbl, self._slot_tuple(slots, w),
                                        hyper, pack, rule)
            return table, slots
        rows = tbl.shape[0] if layout is None else layout.rows
        uids, gsum, n_unique = _combine_sorted_stored(sorted_ids, g_sorted, pack, rows)
        if layout is not None:
            return sharded_row_update(self, table, slots, uids, gsum, step, layout, n_unique)
        trace.count_device("touched_rows", n_unique)
        return self.update(table, slots, uids, gsum, step, n_valid=n_unique)

    def update_from_host_aux(self, table: torch.Tensor, slots: Dict[str, torch.Tensor],
                             flat_g: torch.Tensor, aux: Dict, step: torch.Tensor,
                             layout=None):
        """Trusted PRESORTED route, in place.

        Args:
            table: ``(R, P*E)`` packed stored table.
            slots: the optimizer's slots of ``table``.
            flat_g: ``(M, E)`` per-slot grads in original slot order.
            aux: ``order``, ``lo``, ``seg``, ``uids`` (``(M,)`` int32 on the
                table's device) and ``n_unique`` from the port's
                :class:`~torecsys_tpu_torch.data.presort.Presorter`, which
                has checked that every id addresses a row of ``table``.
                ``n_unique`` is a host int, or (as the trainer places it) a
                one-element int32 tensor on the table's device, which the
                update kernel reads there: nothing is read back, so the step
                can be captured in a CUDA graph.
            step: 0-d int tensor of completed steps.
            layout: with a row-sharded table, its ``RowLayout``: ``table``
                and ``slots`` are this rank's shard, the aux the global
                batch's (:func:`sharded_row_update`).
        """
        e = flat_g.shape[-1]
        pack = table.shape[-1] // e
        g_sorted = KE.row_gather(flat_g.contiguous(), aux["order"])
        gsum = _sorted_gsum(g_sorted, aux["lo"], aux["seg"], pack)
        n_unique = aux["n_unique"]
        if isinstance(n_unique, torch.Tensor):
            n_unique = n_unique.reshape(())
        if layout is not None:
            return sharded_row_update(self, table, slots, aux["uids"], gsum, step, layout,
                                      n_unique)
        return self.update(table, slots, aux["uids"], gsum, step, n_valid=n_unique)


@dataclasses.dataclass(frozen=True)
class RowAdam(_RowOptimizerBase):
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
        """``step`` is the 0-d int tensor of completed steps; bias correction
        uses ``t = step + 1``, computed in float32 as the JAX package does."""
        t = (step + 1).to(torch.float32)
        b1 = torch.full((), self.b1, dtype=torch.float32, device=step.device)
        b2 = torch.full((), self.b2, dtype=torch.float32, device=step.device)
        bc1 = 1.0 / (1.0 - torch.pow(b1, t))
        bc2 = 1.0 / (1.0 - torch.pow(b2, t))
        return _hyper(step, self.learning_rate, b1, b2, self.eps, self.weight_decay,
                      bc1, bc2), "adam"

    def _slot_tuple(self, slots, w):
        return (slots["mv"].reshape(-1, 2, w),)


@dataclasses.dataclass(frozen=True)
class RowAdagrad(_RowOptimizerBase):
    """Lazy row-wise Adagrad (``optax.adagrad``'s scale_by_rss); slot ``v``
    of the table's shape."""

    learning_rate: float = 1e-3
    initial_accumulator_value: float = 0.1
    eps: float = 1e-7

    def init(self, table: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"v": torch.full_like(table, self.initial_accumulator_value)}

    def hyper_and_rule(self, step: torch.Tensor):
        return _hyper(step, self.learning_rate, 0.0, 0.0, self.eps, 0.0, 1.0, 1.0), "adagrad"

    def _slot_tuple(self, slots, w):
        return (slots["v"].reshape(-1, w),)


@dataclasses.dataclass(frozen=True)
class RowSGD(_RowOptimizerBase):
    """Row-wise plain SGD (no momentum); no slots."""

    learning_rate: float = 1e-3

    def init(self, table: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def hyper_and_rule(self, step: torch.Tensor):
        return _hyper(step, self.learning_rate, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0), "sgd"


def get_row_optimizer(method: str = "Adam", lr: float = 1e-3, **kwargs) -> Optional[object]:
    """Row-wise twin of ``train.optimizers.get_optimizer`` for the names that
    have a lazy formulation; None when the config is unsupported."""
    lr = kwargs.pop("learning_rate", lr)
    name = method.lower()
    try:
        if name == "adam":
            return RowAdam(learning_rate=lr, **kwargs)
        if name == "adamw":
            kwargs.setdefault("weight_decay", 1e-4)  # optax.adamw default
            return RowAdam(learning_rate=lr, **kwargs)
        if name == "adagrad":
            return RowAdagrad(learning_rate=lr, **kwargs)
        if name == "sgd" and not kwargs:
            return RowSGD(learning_rate=lr)
    except TypeError:  # unsupported kwarg for this optimizer
        return None
    return None


__all__ = ["RowAdagrad", "RowAdam", "RowSGD", "dedup_sum", "dedup_sum_fields",
           "dedup_sum_stored", "fused_dedup_enabled", "get_row_optimizer", "prefix_sum",
           "sharded_row_update", "sort_bag_grads", "sort_slot_grads"]
