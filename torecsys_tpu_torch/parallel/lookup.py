"""Sharded embedding lookup (counterpart of ``torecsys_tpu/parallel/lookup.py``).

Embedding tables row-sharded over the ``table`` axis, batches split over
``data``: each rank looks up the ids of its data slice, and every table rank
of a data slice ends up with the same ``(B/dp, ..., E)`` rows.  Two
collectives behind one signature, as in the JAX package:

* ``psum`` (contribute-and-reduce): each table rank gathers the rows it owns
  (zeros elsewhere) and ``all_reduce`` sums them over the table group.  The
  packed form decodes the in-row slot before the reduce, so the payload is
  ``(B/dp, K, E)``.  Its cotangent is the same on every table rank (each
  computes the same tower on the same slice): the backward scatters it into
  the rank's own rows.
* ``alltoall`` (unique-id exchange): the slot axis is split over the table
  ranks (``-1`` pads it); each dedups its slice, sends each unique logical
  id to its owner in a bucket of static capacity ``min(m, max(1,
  ceil(m * capacity_factor / ts)))``, the owners gather and send the rows
  back, and an ``all_gather`` over the table group joins the slices.  A
  bucket over capacity poisons that rank's whole output slice with NaN.
  The backward is the reverse exchange, then a scatter-add into the owned
  rows.
* ``auto``: the calibrated byte model (:func:`modeled_comm_mb`) picks per
  lookup.

Each table rank's gather is the ``row_gather`` kernel (``ops.embedding.
packed_lookup``), and its backward the lookup's ``table_grad``.  A
replicated table whose lookups route through the collective (the JAX rule
checks only the row count) serves its padded share of the rows from its full
copy, and its backward sums the whole cotangent into the copy.

The field-aware ``(N, Vp, W)`` table, row-sharded on its middle axis, is
looked up over its flat view with the owner of each row by its block
(:class:`~torecsys_tpu_torch.parallel.sharding.RowLayout`).  The psum's
values do not depend on who owns a row.  The all-to-all buckets by that
owner, where the JAX package's sparse route splits the flat view
contiguously (and its dense route exchanges table by table), so the two can
overflow at different points; without an overflow the values agree.

The multi-hot input's pooled lookup (:func:`maybe_sharded_pooled_lookup`)
takes the psum alone: each table rank sums, in one ``pooled_row_gather``,
the rows it owns of each bag, and ``all_reduce`` sums the ``(B/dp, N, E)``
bag sums over the table group, a payload ``S / N`` times smaller than the
``(B/dp, S, E)`` rows of reducing before pooling.  ``alltoall`` and
``auto`` refuse it.  With the tracer on (``utils.trace``) the gather is the
device span ``pool`` and the reduce the span ``exchange``, both inside
``lookup``.

Activation: input modules call :func:`maybe_sharded_lookup`,
:func:`maybe_sharded_packed_lookup` or :func:`maybe_sharded_pooled_lookup`;
inside ``with use_sharded_lookup(mesh):``
(which the Trainer enters around every step, evaluation and prediction)
they route through the collectives, otherwise they are one plain gather.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional

import torch

from torecsys_tpu_torch.ops.embedding import packed_lookup, pooled_grad, pooled_lookup, table_grad
from torecsys_tpu_torch.ops.kernels.embedding import pooled_row_gather
from torecsys_tpu_torch.parallel.mesh import DATA_AXIS, TABLE_AXIS, Mesh
from torecsys_tpu_torch.parallel.sharding import DEFAULT_MIN_ROWS_TO_SHARD, RowLayout
from torecsys_tpu_torch.utils import trace

INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class LookupContext:
    """Configuration of the sharded lookups: the mesh, its axis names, the
    collective (``psum``, ``alltoall`` or ``auto``), the all-to-all bucket
    capacity as a fraction of the local slots (``capacity_factor``;
    worst-case-safe is the table axis' size), and ``min_rows_to_shard``, the
    stored rows under which a table takes the plain gather (default the
    placement's :data:`~torecsys_tpu_torch.parallel.sharding.DEFAULT_MIN_ROWS_TO_SHARD`,
    so placement and routing agree)."""

    mesh: Mesh
    data_axis: str = DATA_AXIS
    table_axis: str = TABLE_AXIS
    strategy: str = "psum"
    capacity_factor: float = 2.0
    min_rows_to_shard: int = None  # resolved in __post_init__

    def __post_init__(self):
        if self.min_rows_to_shard is None:
            object.__setattr__(self, "min_rows_to_shard", DEFAULT_MIN_ROWS_TO_SHARD)
        if self.strategy not in ("psum", "alltoall", "auto"):
            raise ValueError(f"unknown strategy {self.strategy!r}")


_state = threading.local()

# The auto strategy's byte model, as the JAX package calibrated it on XLA's
# collective bytes (COMM_VOLUME.json, tools/comm_volume.py --sweep): both
# strategies share an assembly term that cancels; psum's distinguishing term
# is one (B, K, E) activation pass, the all-to-all's its capacity-scaled
# bucket exchange, ts * cap * (4 + 8E) bytes a device, times a fitted slack.
_BETA = 1.2


def modeled_comm_mb(strategy: str, m_slots: int, embed_size: int,
                    capacity_factor: float = 2.0, table_shards: int = 8,
                    data_shards: int = 1) -> float:
    """Modeled per-device, per-step (forward and backward) differentiating
    collective MB of a strategy (the JAX package's model, unchanged)."""
    m_dev = m_slots / max(1, data_shards)
    if strategy == "psum":
        return m_dev * embed_size * 4.0 / 1e6
    if strategy == "alltoall":
        ts = max(1, table_shards)
        m_local = m_dev / ts
        cap = max(1.0, -(-capacity_factor * m_local // ts))
        return _BETA * ts * cap * (4.0 + 8.0 * embed_size) / 1e6
    raise ValueError(f"unknown strategy {strategy!r}")


def resolve_strategy(ctx: LookupContext, m_slots: int, embed_size: int) -> str:
    """``ctx.strategy``, with ``auto`` resolved to the modeled-cheaper
    collective; ``m_slots`` counts the global batch's ids."""
    if ctx.strategy != "auto":
        return ctx.strategy
    ts = ctx.mesh.shape.get(ctx.table_axis, 1)
    dp = ctx.mesh.shape.get(ctx.data_axis, 1)
    a2a = modeled_comm_mb("alltoall", m_slots, embed_size, ctx.capacity_factor, ts, dp)
    psum = modeled_comm_mb("psum", m_slots, embed_size, table_shards=ts, data_shards=dp)
    return "alltoall" if a2a < psum else "psum"


def _context() -> Optional[LookupContext]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def use_sharded_lookup(mesh: Mesh, **kwargs):
    """Route the embedding lookups called inside this block through the
    sharded path (``kwargs`` are :class:`LookupContext`'s)."""
    prev = _context()
    _state.ctx = LookupContext(mesh=mesh, **kwargs)
    try:
        yield _state.ctx
    finally:
        _state.ctx = prev


class _DataMean(torch.autograd.Function):
    """The mean over the data group of equal slices' ``x``; its cotangent is
    the data group's mean of the ranks' cotangents."""

    @staticmethod
    def forward(fctx, x, mesh, axis):
        fctx.mesh, fctx.axis = mesh, axis
        return mesh.all_reduce(x.clone(), axis) / mesh.shape[axis]

    @staticmethod
    def backward(fctx, g):
        return fctx.mesh.all_reduce(g.clone(), fctx.axis) / fctx.mesh.shape[fctx.axis], None, None


def data_mean(x: torch.Tensor) -> torch.Tensor:
    """``x``, a statistic of this rank's data slice, as the global batch's:
    its mean over the data group inside :func:`use_sharded_lookup` when the
    data axis is split (a BatchNorm's batch statistics, as the JAX
    package's SPMD step takes them over the global batch), else ``x``."""
    ctx = _context()
    if ctx is None or ctx.mesh.shape.get(ctx.data_axis, 1) == 1:
        return x
    return _DataMean.apply(x, ctx.mesh, ctx.data_axis)


def _layout(table: torch.Tensor, ctx: LookupContext, layout: Optional[RowLayout]) -> RowLayout:
    """A sharded table's own layout, or a replicated table's serving split."""
    if layout is not None:
        return layout
    rows = math.prod(table.shape[:-1])
    return RowLayout(rows=rows, shards=ctx.mesh.shape[ctx.table_axis],
                     index=ctx.mesh.index(ctx.table_axis), sharded=False)


def _collective(ctx: Optional[LookupContext], rows: int) -> bool:
    """Whether a table of ``rows`` global stored rows routes through a
    collective (the JAX package's routing conditions)."""
    if ctx is None or ctx.table_axis not in ctx.mesh.axis_names:
        return False
    if ctx.mesh.shape[ctx.table_axis] == 1 and ctx.mesh.shape.get(ctx.data_axis, 1) == 1:
        return False
    return rows >= ctx.min_rows_to_shard


def maybe_sharded_lookup(table: torch.Tensor, ids: torch.Tensor,
                         layout: Optional[RowLayout] = None) -> torch.Tensor:
    """``table[ids]`` for an unpacked ``(V, E)`` table (this rank's rows of
    it when ``layout`` is given): sharded inside :func:`use_sharded_lookup`,
    a plain gather otherwise."""
    return maybe_sharded_packed_lookup(table, ids, table.shape[-1], layout)


def maybe_sharded_packed_lookup(packed_table: torch.Tensor, ids: torch.Tensor,
                                embed_size: int,
                                layout: Optional[RowLayout] = None) -> torch.Tensor:
    """Packed-layout ``logical_table[ids]``: sharded inside
    :func:`use_sharded_lookup` when the table is large enough, a plain
    gather (``ops.embedding.packed_lookup``) otherwise.

    Args:
        packed_table: the ``(Vp, P*E)`` (or field-aware ``(N, Vp, P*E)``)
            table, or with ``layout`` this rank's rows of it.
        ids: ``(B/dp, ...)`` logical ids of this rank's data slice.
        embed_size: E.
        layout: the table's :class:`RowLayout` when it is sharded.
    """
    ctx = _context()
    rows = layout.rows if layout is not None else math.prod(packed_table.shape[:-1])
    if not _collective(ctx, rows):
        if layout is not None:
            raise RuntimeError("a row-sharded table looked up outside use_sharded_lookup")
        return packed_lookup(packed_table, ids, embed_size)
    m_global = ids.numel() * ctx.mesh.shape.get(ctx.data_axis, 1)
    if resolve_strategy(ctx, m_global, embed_size) == "alltoall":
        return sharded_packed_lookup_alltoall(packed_table, ids, embed_size, ctx, layout)
    return sharded_packed_lookup(packed_table, ids, embed_size, ctx, layout)


def _served_ids(ids: torch.Tensor, pack: int, layout: RowLayout):
    """(local logical ids, served mask) of flat logical ``ids``: where this
    rank reads each id it serves (0 elsewhere)."""
    r = torch.div(ids, pack, rounding_mode="floor")
    ok = layout.served(r)
    local = layout.local(r) * pack + (ids - r * pack)
    return torch.where(ok, local, torch.zeros_like(local)), ok


def _gather_owned(table, local_ids, ok, embed_size):
    rows = packed_lookup(table, local_ids, embed_size)
    return torch.where(ok[:, None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))


def _scatter_grad(ids, ok, grad, table):
    """``table_grad`` of the ``ok`` ids (the others dropped: an id past
    the table's logical rows adds nothing)."""
    w = table.shape[-1]
    e = grad.shape[-1]
    oob = math.prod(table.shape[:-1]) * (w // e)
    keys = torch.where(ok, ids, torch.full_like(ids, oob))
    return table_grad(keys, grad, table.shape, table.dtype)


def _replica_grad(ids, grad, table):
    """A replicated table's gradient: every id of the slice that lies in
    the table, from the whole cotangent (the same on every table rank)."""
    rows = math.prod(table.shape[:-1]) * (table.shape[-1] // grad.shape[-1])
    return _scatter_grad(ids, (ids >= 0) & (ids < rows), grad, table)


class _PsumLookup(torch.autograd.Function):
    @staticmethod
    def forward(fctx, table, flat_ids, embed_size, layout, ctx):
        pack = table.shape[-1] // embed_size
        local_ids, ok = _served_ids(flat_ids, pack, layout)
        rows = _gather_owned(table, local_ids, ok, embed_size)
        ctx.mesh.all_reduce(rows, ctx.table_axis)
        fctx.save_for_backward(flat_ids, local_ids, ok)
        fctx.layout = layout
        fctx.table_meta = (table.shape, table.dtype)
        return rows

    @staticmethod
    def backward(fctx, grad):
        flat_ids, local_ids, ok = fctx.saved_tensors
        like = torch.empty(fctx.table_meta[0], dtype=fctx.table_meta[1], device="meta")
        if fctx.layout.sharded:
            d = _scatter_grad(local_ids, ok, grad, like)
        else:
            d = _replica_grad(flat_ids, grad, like)
        return d, None, None, None, None


def sharded_packed_lookup(packed_table: torch.Tensor, ids: torch.Tensor, embed_size: int,
                          ctx: LookupContext, layout: Optional[RowLayout] = None) -> torch.Tensor:
    """Row-sharded packed lookup: contribute-and-psum over ``table``.

    Args:
        packed_table: this rank's rows (with ``layout``) or a full replica.
        ids: ``(B/dp, ...)`` logical ids of this rank's data slice.
        embed_size: E.
        ctx: the active :class:`LookupContext`.
        layout: the table's :class:`RowLayout` when it is sharded.

    Returns:
        ``(B/dp, ..., E)``, the same on every table rank of the slice.
    """
    lay = _layout(packed_table, ctx, layout)
    out = _PsumLookup.apply(packed_table, ids.reshape(-1).to(torch.int64), embed_size, lay, ctx)
    return out.reshape(*ids.shape, embed_size)


def sharded_lookup(table: torch.Tensor, ids: torch.Tensor, ctx: LookupContext,
                   layout: Optional[RowLayout] = None) -> torch.Tensor:
    """Row-sharded lookup of an unpacked ``(V, E)`` table via
    contribute-and-psum (:func:`sharded_packed_lookup` at ``P = 1``)."""
    return sharded_packed_lookup(table, ids, table.shape[-1], ctx, layout)


def _dedup_ids(flat_ids: torch.Tensor):
    """Static-size dedup of a 1-D id stream: ``(uids, inv, n_unique)``,
    ascending unique int32 ids padded with ``INT32_MAX`` to the input's
    length, each slot's index into ``uids``, and the 0-d unique count."""
    from torecsys_tpu_torch.ops.sparse import _segments

    m = flat_ids.shape[0]
    sorted_ids, order = torch.sort(flat_ids.to(torch.int32), stable=True)
    seg = _segments(sorted_ids)
    uids = torch.full((m,), INT32_MAX, dtype=torch.int32, device=flat_ids.device)
    uids.scatter_(0, seg.long(), sorted_ids)  # every writer of a slot writes one value
    inv = torch.zeros(m, dtype=torch.int32, device=flat_ids.device).scatter_(0, order, seg)
    return uids, inv, seg[-1] + 1


def _slots_split_for_alltoall(ids: torch.Tensor, ts: int):
    """``(B, K')`` ids padded with ``-1`` to a slot axis that splits evenly
    over ``ts`` table ranks, and the original K."""
    b = ids.shape[0]
    flat = ids.reshape(b, -1)
    k = flat.shape[1]
    pad = (-k) % ts
    if pad:
        flat = torch.cat([flat, flat.new_full((b, pad), -1)], dim=1)
    return flat, k


def _capacity(m: int, capacity_factor: float, ts: int) -> int:
    return min(max(1, int(-(-m * capacity_factor // ts))), m)


class _AlltoallLookup(torch.autograd.Function):
    @staticmethod
    def forward(fctx, table, ids, embed_size, layout, ctx):
        mesh, axis = ctx.mesh, ctx.table_axis
        ts, t = mesh.shape[axis], mesh.index(axis)
        dev = ids.device
        pack = table.shape[-1] // embed_size
        flat, k = _slots_split_for_alltoall(ids.to(torch.int64), ts)
        b, kp = flat.shape
        kl = kp // ts
        mine = flat[:, t * kl:(t + 1) * kl].reshape(-1)
        m = mine.shape[0]
        cap = _capacity(m, ctx.capacity_factor, ts)

        uids, inv, n_unique = _dedup_ids(mine)
        u = torch.arange(m, dtype=torch.int64, device=dev)
        uid64 = uids.to(torch.int64)
        r = torch.div(uid64, pack, rounding_mode="floor")
        owner = torch.where(u < n_unique,
                            torch.where(uid64 >= 0, layout.owner(r.clamp_min(0)), -1), ts)
        counts = (owner[None, :] == torch.arange(ts, device=dev)[:, None]).sum(1)
        n_neg = (owner == -1).sum()
        starts = n_neg + torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
        overflow = (counts > cap).any()
        j = torch.arange(cap, device=dev)[None, :]
        gather_idx = torch.clamp_max(starts[:, None] + j, m - 1)
        send = torch.where(j < counts[:, None], uids[gather_idx], torch.full_like(uids[:1], -1))

        recv = mesh.all_to_all(send, axis).to(torch.int64)  # (ts, cap) logical ids
        local_ids, ok = _served_ids(recv.reshape(-1), pack, layout)
        owned = _gather_owned(table, local_ids, ok, embed_size).reshape(ts, cap, embed_size)
        rows_back = mesh.all_to_all(owned, axis)
        own_u = torch.clamp_max(owner, ts - 1)
        pos_u = torch.clamp(u - starts[own_u], 0, cap - 1)
        rows = rows_back[own_u, pos_u].index_select(0, inv.long())
        rows = torch.where(overflow, torch.full((), float("nan"), dtype=rows.dtype, device=dev),
                           rows)
        gathered = mesh.all_gather(rows.reshape(b, kl, embed_size), axis)  # (ts, b, kl, E)
        out = gathered.permute(1, 0, 2, 3).reshape(b, kp, embed_size)[:, :k]

        fctx.save_for_backward(ids, inv, own_u, pos_u, local_ids, ok, overflow)
        fctx.dims = (ts, t, b, k, kp, kl, m, cap)
        fctx.layout, fctx.ctx = layout, ctx
        fctx.table_meta = (table.shape, table.dtype)
        return out.reshape(*ids.shape, embed_size)

    @staticmethod
    def backward(fctx, grad):
        ids, inv, own_u, pos_u, local_ids, ok, overflow = fctx.saved_tensors
        ts, t, b, k, kp, kl, m, cap = fctx.dims
        like = torch.empty(fctx.table_meta[0], dtype=fctx.table_meta[1], device="meta")
        e = grad.shape[-1]
        if not fctx.layout.sharded:
            flat = ids.reshape(-1).to(torch.int64)
            return _replica_grad(flat, grad.reshape(-1, e), like), None, None, None, None
        g = grad.reshape(b, k, e)
        if kp > k:
            g = torch.cat([g, g.new_zeros(b, kp - k, e)], dim=1)
        g_mine = g[:, t * kl:(t + 1) * kl].reshape(m, e)
        g_mine = torch.where(overflow, torch.zeros((), dtype=g.dtype, device=g.device), g_mine)
        d_unique = g_mine.new_zeros(m, e).index_add_(0, inv.long(), g_mine)
        d_back = g_mine.new_zeros(ts, cap, e)
        d_back.index_put_((own_u, pos_u), d_unique, accumulate=True)
        d_owned = fctx.ctx.mesh.all_to_all(d_back, fctx.ctx.table_axis).reshape(-1, e)
        return _scatter_grad(local_ids, ok, d_owned, like), None, None, None, None


def sharded_packed_lookup_alltoall(packed_table: torch.Tensor, ids: torch.Tensor,
                                   embed_size: int, ctx: LookupContext,
                                   layout: Optional[RowLayout] = None) -> torch.Tensor:
    """Packed-layout unique-id all-to-all lookup: the ranks exchange
    LOGICAL ids and E-wide rows, and each owner decodes its packed layout.
    Arguments and result as :func:`sharded_packed_lookup`."""
    lay = _layout(packed_table, ctx, layout)
    return _AlltoallLookup.apply(packed_table, ids, embed_size, lay, ctx)


def sharded_lookup_alltoall(table: torch.Tensor, ids: torch.Tensor, ctx: LookupContext,
                            layout: Optional[RowLayout] = None) -> torch.Tensor:
    """Row-sharded lookup of an unpacked ``(V, E)`` table via the unique-id
    all-to-all (:func:`sharded_packed_lookup_alltoall` at ``P = 1``)."""
    return sharded_packed_lookup_alltoall(table, ids, table.shape[-1], ctx, layout)


def _pooled(table, ids, starts, embed_size, lo, hi, base):
    """The ``pooled_row_gather`` of the served rows, as the span ``pool``."""
    trace.mark("pool.begin")
    out = pooled_row_gather(table.reshape(-1, embed_size), ids, starts, lo, hi, base)
    trace.mark("pool.end")
    return out


def _served_range(layout: RowLayout, pack: int):
    """``(lo, hi, base)``: the logical rows this table rank serves and the
    logical row of its table's first row (a 2-D table's layout)."""
    s = layout.shard_rows
    lo = layout.index * s
    hi = min(lo + s, layout.rows)
    base = lo if layout.sharded else 0
    return lo * pack, hi * pack, base * pack


class _PsumPooled(torch.autograd.Function):
    @staticmethod
    def forward(fctx, table, ids, starts, bags, embed_size, layout, ctx):
        lo, hi, base = _served_range(layout, table.shape[-1] // embed_size)
        out = _pooled(table, ids, starts, embed_size, lo, hi, base)
        trace.mark("exchange.begin")
        ctx.mesh.all_reduce(out, ctx.table_axis)
        trace.mark("exchange.end")
        fctx.save_for_backward(ids, bags)
        fctx.meta = (table.shape, table.dtype, lo, hi, base, layout.sharded)
        return out

    @staticmethod
    def backward(fctx, grad):
        ids, bags = fctx.saved_tensors
        shape, dtype, lo, hi, base, sharded = fctx.meta
        if not sharded:  # a replicated copy takes every id's share
            lo, hi = 0, math.prod(shape[:-1]) * (shape[-1] // grad.shape[-1])
        d = pooled_grad(ids, grad, bags, shape, dtype, lo, hi, base)
        return d, None, None, None, None, None, None


def maybe_sharded_pooled_lookup(packed_table: torch.Tensor, ids: torch.Tensor,
                                starts: torch.Tensor, bags: torch.Tensor, embed_size: int,
                                layout: Optional[RowLayout] = None) -> torch.Tensor:
    """Bag sums of a multi-hot lookup (``ops.embedding.pooled_lookup``):
    inside :func:`use_sharded_lookup` and for a table large enough, each
    table rank's sums of the rows it serves, reduced over the table group
    (the psum strategy; ``alltoall`` and ``auto`` raise ``ValueError``);
    one plain pooled gather otherwise.

    Args:
        packed_table: the 2-D ``(Vp, P*E)`` float32 table, or with
            ``layout`` this rank's rows of it.
        ids: ``(B/dp, S)`` logical ids of this rank's data slice.
        starts: ``(N + 1,)`` int32 slot offsets of the bags, on the table's
            device; ``bags``: ``(S,)`` int64, each slot's bag.
        embed_size: E.
        layout: the table's :class:`RowLayout` when it is sharded.

    Returns:
        ``(B/dp, N, E)`` float32, the same on every table rank of the slice.
    """
    ctx = _context()
    rows = layout.rows if layout is not None else math.prod(packed_table.shape[:-1])
    if not _collective(ctx, rows):
        if layout is not None:
            raise RuntimeError("a row-sharded table looked up outside use_sharded_lookup")
        trace.mark("pool.begin")
        out = pooled_lookup(packed_table, ids, starts, bags, embed_size)
        trace.mark("pool.end")
        return out
    if ctx.strategy != "psum":
        raise ValueError(f"the multi-hot (pooled) lookup takes the 'psum' strategy only, not "
                         f"{ctx.strategy!r}: a multi-hot all-to-all exchange is not built; "
                         "pass lookup_options={'strategy': 'psum'}")
    lay = _layout(packed_table, ctx, layout)
    if lay.blocks != 1:
        raise ValueError("the pooled lookup takes a 2-D table")
    return _PsumPooled.apply(packed_table, ids, starts, bags, embed_size, lay, ctx)


__all__ = ["LookupContext", "data_mean", "maybe_sharded_lookup", "maybe_sharded_packed_lookup",
           "maybe_sharded_pooled_lookup", "modeled_comm_mb", "resolve_strategy",
           "sharded_lookup", "sharded_lookup_alltoall", "sharded_packed_lookup",
           "sharded_packed_lookup_alltoall", "use_sharded_lookup"]
