"""Sharding rules: where every parameter and batch array lives on the mesh
(counterpart of ``torecsys_tpu/parallel/sharding.py``).

The rules are the JAX package's, letter for letter:

* an embedding table (its path contains ``embedding``, two dimensions or
  more, a table axis of more than one rank) is **row-sharded** when its
  stored row count divides the table axis and is at least
  ``min_rows_to_shard``: a 2-D ``(R, W)`` table splits its rows, a 3-D
  field-aware ``(N, Vp, W)`` table its middle axis;
* every other parameter is replicated;
* a batch array is split over ``data`` on its leading axis (its second for a
  ``(K, B, ...)`` stack).

A decision is a partition spec as a tuple, as ``PartitionSpec`` reads:
``("table", None)``, ``(None, "table", None)`` or ``()``.

The port keeps plain tensors: a rank holds its shard of each sharded table
as the table parameter itself, and :class:`RowLayout` says which global
stored rows it holds.  A replicated table whose lookups still route through
the collective (``parallel.lookup`` checks only the row count, and pads)
gets a layout too, with ``sharded=False``: each table rank serves its
contiguous, padded share of the rows from its full copy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from torecsys_tpu_torch.parallel.mesh import DATA_AXIS, TABLE_AXIS, Mesh

# Tables with fewer stored rows than this replicate instead of row-sharding:
# the JAX package's constant, which placement (here) and lookup routing
# (parallel.lookup) both read, so a replicated small table is never routed
# through the collective.
DEFAULT_MIN_ROWS_TO_SHARD = 1 << 16


def _spec(path: str, shape, ts: int, min_rows: int, table_axis: str):
    if "embedding" in path and len(shape) >= 2 and ts > 1:
        if len(shape) == 2 and shape[0] % ts == 0 and shape[0] >= min_rows:
            return (table_axis, None)
        if len(shape) == 3 and shape[1] % ts == 0 and shape[1] >= min_rows:
            return (None, table_axis, None)
    return ()


def _map_leaves(tree, fn, prefix: str = ""):
    if isinstance(tree, Mapping):
        return {k: _map_leaves(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def infer_param_sharding(params: Any, mesh: Mesh, table_axis: str = TABLE_AXIS,
                         min_rows_to_shard: int = DEFAULT_MIN_ROWS_TO_SHARD) -> Any:
    """The partition spec of every parameter.

    ``params`` is a module (its ``named_parameters``: the result maps each
    name to its spec) or a nested mapping of arrays or tensors (the result
    has its structure, each path joined with ``/`` for the rule, as flax
    paths are).
    """
    ts = mesh.shape.get(table_axis, 1)
    if isinstance(params, nn.Module):
        return {name: _spec(name, tuple(p.shape), ts, min_rows_to_shard, table_axis)
                for name, p in params.named_parameters()}
    return _map_leaves(params, lambda path, leaf: _spec(
        path, tuple(np.shape(leaf)), ts, min_rows_to_shard, table_axis))


@dataclasses.dataclass(frozen=True)
class RowLayout:
    """Which global stored rows of a table one table rank holds or serves.

    ``rows`` counts the stored rows of the table's flat ``(R, W)`` view
    (``N * Vp`` for a field-aware ``(N, Vp, W)`` table, ``blocks = N``).  A
    sharded table (``sharded=True``) splits each block's rows into
    ``shards`` contiguous runs of ``shard_rows``: rank ``index`` holds run
    ``index`` of every block, in block order.  A replicated table
    (``sharded=False``) is held whole; for its collective lookups the flat
    rows, padded to a multiple of ``shards``, split into contiguous runs.
    """

    rows: int
    shards: int
    index: int
    blocks: int = 1
    sharded: bool = True

    @property
    def block_rows(self) -> int:
        return self.rows // self.blocks

    @property
    def shard_rows(self) -> int:
        if self.sharded:
            return self.block_rows // self.shards
        return -(-self.rows // self.shards)

    @property
    def local_rows(self) -> int:
        return self.blocks * self.shard_rows if self.sharded else self.rows

    def owner(self, r: torch.Tensor) -> torch.Tensor:
        """The table rank of global stored rows ``r >= 0``."""
        if self.blocks == 1:
            return torch.div(r, self.shard_rows, rounding_mode="floor")
        return torch.div(r % self.block_rows, self.shard_rows, rounding_mode="floor")

    def local(self, r: torch.Tensor) -> torch.Tensor:
        """Where this rank keeps the global stored rows ``r`` that it owns."""
        if not self.sharded:
            return r
        if self.blocks == 1:
            return r - self.index * self.shard_rows
        s = self.shard_rows
        return (torch.div(r, self.block_rows, rounding_mode="floor") * s
                + r % self.block_rows - self.index * s)

    def served(self, r: torch.Tensor) -> torch.Tensor:
        """Whether this rank serves global stored rows ``r`` in a collective
        lookup: its own rows, or its share of a replicated table's (a padding
        row past the table is served as zeros by nobody)."""
        return (r >= 0) & (r < self.rows) & (self.owner(r) == self.index)

    def table_shape(self, width: int) -> Tuple[int, ...]:
        """The whole table's shape, of stored rows ``width`` wide."""
        return ((self.rows,) if self.blocks == 1 else (self.blocks, self.block_rows)) + (width,)

    def global_rows(self) -> torch.Tensor:
        """The global stored rows this rank holds, in its local order (a
        sharded table's only)."""
        s, vp = self.shard_rows, self.block_rows
        base = torch.arange(s, dtype=torch.int64) + self.index * s
        return (base[None, :] + torch.arange(self.blocks, dtype=torch.int64)[:, None] * vp
                ).reshape(-1)


def table_layout(shape, spec, mesh: Mesh, table_axis: str = TABLE_AXIS):
    """The :class:`RowLayout` of a table of global ``shape`` placed by
    ``spec``, or None when ``spec`` replicates it."""
    if not spec:
        return None
    ts, t = mesh.shape[table_axis], mesh.index(table_axis)
    if len(shape) == 2:
        return RowLayout(rows=shape[0], shards=ts, index=t)
    return RowLayout(rows=shape[0] * shape[1], shards=ts, index=t, blocks=shape[0])


def axis_layout(layout: RowLayout, axis):
    """The layout of a tensor beside a row-sharded table (an optimizer's
    state) whose ``axis`` indexes the table's local rows: the table's own
    where the tensor keeps the rows' leading axes (axis 0 of a 2-D table's,
    axis 1 of a field-aware table's after its block axis), one block's rows
    where a field-aware table's state dropped the block axis (axis 0); None
    for ``axis`` None (a reduced tensor, replicated)."""
    if axis is None:
        return None
    if layout.blocks == 1 or axis == 1:
        return layout
    return RowLayout(rows=layout.block_rows, shards=layout.shards, index=layout.index)


def local_shard(value, layout: RowLayout):
    """The rows of the global ``value`` (``(R, ...)`` or ``(N, Vp, ...)``,
    numpy or torch) that ``layout``'s rank holds."""
    s, t = layout.shard_rows, layout.index
    if layout.blocks == 1:
        return value[t * s:(t + 1) * s]
    return value[:, t * s:(t + 1) * s]


def shard_params(params: Any, mesh: Mesh, table_axis: str = TABLE_AXIS,
                 min_rows_to_shard: int = DEFAULT_MIN_ROWS_TO_SHARD) -> Any:
    """Place ``params`` on the mesh per :func:`infer_param_sharding`.

    A nested mapping of arrays or tensors gives the same structure with this
    rank's rows of each sharded table and every other leaf as it is.  A
    module is sharded in place (:func:`shard_module`) and returned.
    """
    if isinstance(params, nn.Module):
        shard_module(params, mesh, table_axis, min_rows_to_shard)
        return params
    specs = infer_param_sharding(params, mesh, table_axis, min_rows_to_shard)

    def place(leaf, spec):
        if isinstance(leaf, Mapping):
            return {k: place(v, spec[k]) for k, v in leaf.items()}
        layout = table_layout(np.shape(leaf), spec, mesh, table_axis)
        return leaf if layout is None else local_shard(leaf, layout)

    return place(params, specs)


def _table_owners(module: nn.Module) -> Dict[str, nn.Module]:
    """``{parameter name: owning module}`` of the parameters named
    ``embedding`` whose modules look their rows up through
    ``parallel.lookup`` (the table and sequence inputs)."""
    return {f"{name}.embedding" if name else "embedding": m
            for name, m in module.named_modules()
            if isinstance(getattr(m, "embedding", None), nn.Parameter)
            and hasattr(m, "row_layout")}


def shard_module(seq: nn.Module, mesh: Mesh, table_axis: str = TABLE_AXIS,
                 min_rows_to_shard: int = DEFAULT_MIN_ROWS_TO_SHARD) -> Dict[str, RowLayout]:
    """Shard ``seq``'s tables in place: each sharded table's parameter
    becomes this rank's rows (a new contiguous parameter) and its module's
    ``row_layout`` records them.  Returns ``{parameter name: layout}``.
    A table not yet allocated (on the ``meta`` device) stays so, at its
    rows' shape, for ``reset_parameters`` to allocate and draw
    (:func:`draw_table`).

    Raises ``NotImplementedError`` for a parameter that the rules shard but
    whose module does not look up through ``parallel.lookup``."""
    specs = infer_param_sharding(seq, mesh, table_axis, min_rows_to_shard)
    owners = _table_owners(seq)
    layouts = {}
    for name, spec in specs.items():
        if not spec:
            continue
        module = owners.get(name)
        if module is None:
            raise NotImplementedError(f"parameter {name!r} is placed row-sharded by the rules, "
                                      "but its module does not look up through "
                                      "parallel.lookup")
        param = module.embedding
        layout = table_layout(tuple(param.shape), spec, mesh, table_axis)
        module.embedding = nn.Parameter(local_shard(param.detach(), layout).contiguous(),
                                        requires_grad=param.requires_grad)
        module.row_layout = layout
        layouts[name] = layout
    return layouts


def unshard_module(seq: nn.Module) -> None:
    """Give every sharded table of ``seq`` back an unallocated parameter (on
    the ``meta`` device) of its global shape and dtype, which
    ``reset_parameters`` allocates and draws (:func:`draw_table`): the
    rank's old rows go before anything new is allocated."""
    for module in _table_owners(seq).values():
        layout = module.row_layout
        if layout is None:
            continue
        p = module.embedding
        module.embedding = nn.Parameter(
            torch.empty(layout.table_shape(p.shape[-1]), dtype=p.dtype, device="meta"),
            requires_grad=p.requires_grad)
        module.row_layout = None


def allocated_table(module: nn.Module, device) -> nn.Parameter:
    """The table parameter of ``module`` (a table owner, ``_table_owners``),
    allocated on ``device`` at its shape and dtype where it was not (on the
    ``meta`` device); its values are then the caller's to draw."""
    table = module.embedding
    if table.is_meta:
        table = nn.Parameter(torch.empty_like(table, device=device),
                             requires_grad=table.requires_grad)
        module.embedding = table
    return table


def draw_table(module: nn.Module, draw: Callable[[torch.Tensor, Any], None],
               generator: Optional[torch.Generator]) -> None:
    """Draw the table of ``module`` (a table owner, ``_table_owners``):
    ``draw(t, generator)`` fills a float32 tensor ``t`` of the whole table
    in place, and the table keeps the rows its ``row_layout`` names (all of
    them without one), rounded to its dtype.  So each rank of a mesh holds
    its rows of the one-device draw, and the generator advances as for the
    whole table; the whole draw is transient (a whole float32 table is drawn
    in place).  An unallocated table is allocated first, on the generator's
    device (:func:`allocated_table`)."""
    table = allocated_table(module, module.embedding.device if generator is None
                            else generator.device)
    layout = module.row_layout
    with torch.no_grad():
        if layout is None and table.dtype == torch.float32:
            draw(table, generator)
            return
        shape = table.shape if layout is None else layout.table_shape(table.shape[-1])
        whole = torch.empty(shape, dtype=torch.float32, device=table.device)
        draw(whole, generator)
        table.copy_(whole if layout is None else local_shard(whole, layout))


def batch_sharding(mesh: Mesh, data_axis: str = DATA_AXIS, stacked: bool = False):
    """The partition spec of a batch array: the leading axis over ``data``
    (the second for a ``(K, B, ...)`` stack)."""
    del mesh
    return (None, data_axis) if stacked else (data_axis,)


def shard_batch(batch: Dict[str, Any], mesh: Mesh, stacked: bool = False,
                data_axis: str = DATA_AXIS) -> Dict[str, Any]:
    """This rank's data slice of every array of a global batch: rows
    ``[d*B/dp, (d+1)*B/dp)`` of the batch axis."""
    dp, d = mesh.shape[data_axis], mesh.index(data_axis)
    if dp == 1:
        return dict(batch)
    axis = 1 if stacked else 0
    out = {}
    for k, v in batch.items():
        n = np.shape(v)[axis]
        if n % dp:
            raise ValueError(f"batch field {k!r} of {n} rows does not split over the data "
                             f"axis of {dp}")
        size = n // dp
        out[k] = v[(slice(None),) * axis + (slice(d * size, (d + 1) * size),)]
    return out


__all__ = ["DEFAULT_MIN_ROWS_TO_SHARD", "RowLayout", "allocated_table", "axis_layout",
           "batch_sharding", "draw_table", "infer_param_sharding", "local_shard", "shard_batch",
           "shard_module", "shard_params", "table_layout", "unshard_module"]
