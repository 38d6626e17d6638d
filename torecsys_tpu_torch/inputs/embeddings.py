"""Categorical / value input modules (the embedding front-end).

Counterpart of ``torecsys_tpu/inputs/embeddings.py``: :class:`ValueInput`;
three table modules, :class:`SingleIndexEmbedding` (one unpacked table),
:class:`MultiIndicesEmbedding` (the fused table of several categorical
fields with per-field offsets, stored packed, ``ops.embedding``) and
:class:`MultiIndicesFieldAwareEmbedding` (N such tables in one parameter);
the port's own :class:`MultiHotIndicesEmbedding` (the fused table of
multi-hot fields, each bag of ids summed); and the containers
:class:`ConcatInput` and :class:`StackedInput`.

The sparse route, shared by the table modules (:class:`TableInput`).
In flax, ``perturb`` and ``sow`` let the train step take per-slot gradients
and read back the ids.  Here a module with
``sparse_grads`` set, running with autograd on, gathers its rows from the
detached table and returns them as a fresh leaf tensor that requires grad;
it records that leaf, the table's logical row ids and the batch's presort
aux as one :class:`SparseLookup`, which the train step takes back with
:meth:`TableInput.take_lookup` after ``loss.backward()``.  A second
application before the lookup is taken raises: its gradient would be summed
against one call site's ids.  The row-wise optimizer sees each table as the
2-D ``(rows, W)`` view :meth:`TableInput.table_view`, and the module turns
its lookup into the update's id-sorted stream
(:meth:`TableInput.sorted_slot_grads`), by its own rule for the ids.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from torecsys_tpu_torch.inputs.base import BaseInput, Batch
from torecsys_tpu_torch.ops.embedding import bag_starts, field_offsets, packed_shape, slot_bags
from torecsys_tpu_torch.ops.sparse import sort_bag_grads, sort_slot_grads
from torecsys_tpu_torch.parallel.lookup import (maybe_sharded_packed_lookup,
                                                maybe_sharded_pooled_lookup)
from torecsys_tpu_torch.parallel.sharding import allocated_table, draw_table
from torecsys_tpu_torch.utils import DeviceLike, default_generator, resolve_device, trace


@dataclasses.dataclass
class SparseLookup:
    """One sparse-route lookup: the leaf ``rows`` whose ``.grad`` is the
    per-slot table gradient, the shifted ``ids`` and the presort ``aux``
    (None when the batch carries none).  A multi-hot lookup's leaf is its
    ``(B, N, E)`` bag sums and ``ids`` its ``(B, S)`` slots."""

    rows: torch.Tensor
    ids: torch.Tensor
    aux: Optional[Dict]


class ValueInput(BaseInput):
    """Pass dense values through as ``(B, N, 1)`` first-order features."""

    embed_size = 1

    def __init__(self, fields: Sequence[str],
                 transform: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        super().__init__()
        self.fields = tuple(fields)
        self.transform = transform

    def forward(self, batch: Batch) -> torch.Tensor:
        cols = []
        for name in self.fields:
            x = batch[name].to(torch.float32)
            if x.dim() == 1:
                x = x[:, None]
            cols.append(x)
        out = torch.cat(cols, dim=1)[..., None]  # (B, N, 1)
        if self.transform is not None:
            out = self.transform(out)
        return out

    def output_shape(self) -> Tuple[int, int]:
        return len(self.fields), 1


class TableInput(BaseInput):
    """What the three table modules share: the ``embedding`` parameter, its
    storage dtype, and the sparse route's lookup (see the module's
    docstring).  Subclasses build the table and call :meth:`_lookup_rows`
    with logical row ids of :meth:`table_view`'s ``(Vp*P, E)`` view."""

    embed_size: int
    embedding: nn.Parameter

    def _init_table(self, shape, device) -> None:
        self.embedding = nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device))
        self.sparse_grads = False
        self._lookup: Optional[SparseLookup] = None
        # this rank's rows when the table is row-sharded (parallel.sharding)
        self.row_layout = None

    def _draw(self, table: torch.Tensor, generator) -> None:
        """Draw the float32 table in place (the subclass's initializer)."""
        raise NotImplementedError

    def reset_parameters(self, generator=None) -> None:
        """Draw the table in float32 and store it in its dtype (a bf16 table
        holds the float32 draw rounded); under a ``row_layout``, this rank's
        rows of the whole table's draw (``parallel.sharding.draw_table``)."""
        draw_table(self, self._draw, generator)

    def set_table_dtype(self, dtype: torch.dtype) -> None:
        """Store the table in ``dtype`` (float32 or bfloat16; the pipeline's
        ``set_table_dtype``); its values are rounded to it."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"table dtype must be float32 or bfloat16, got {dtype}")
        if self.embedding.dtype != dtype:
            self.embedding = nn.Parameter(self.embedding.detach().to(dtype))

    @property
    def pack(self) -> int:
        return self.embedding.shape[-1] // self.embed_size

    def table_view(self) -> torch.Tensor:
        """The table as the ``(rows, W)`` stored rows the row-wise optimizer
        and the update kernels work on (a view, detached; this rank's rows of
        a row-sharded table)."""
        return self.embedding.detach().reshape(-1, self.embedding.shape[-1])

    def logical_rows(self) -> int:
        """Logical rows of the whole table, ``(stored rows) * P``."""
        stored = (self.row_layout.rows if self.row_layout is not None
                  else self.embedding.numel() // self.embedding.shape[-1])
        return stored * self.pack

    def _gather(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """The lookup of ``ids`` from ``table`` (the parameter, or it
        detached on the sparse route)."""
        return maybe_sharded_packed_lookup(table, ids, self.embed_size, self.row_layout)

    def _lookup_rows(self, ids: torch.Tensor, batch: Optional[Batch]) -> torch.Tensor:
        """``logical_table[ids]``, float32: through autograd into the table,
        or on the sparse route as a recorded leaf."""
        if not (self.sparse_grads and torch.is_grad_enabled()):
            # rows of a bf16 table are cast to float32 here, at the module
            # boundary: the model and the loss see float32
            trace.mark("lookup.begin")
            rows = self._gather(self.embedding, ids).float()
            trace.mark("lookup.end")
            return rows
        if self._lookup is not None:
            raise RuntimeError(
                f"{type(self).__name__} applied twice in one step: sparse embedding "
                "gradients need exactly one lookup per module per step"
            )
        trace.mark("lookup.begin")
        rows = self._gather(self.embedding.detach(), ids)
        trace.mark("lookup.end")
        rows.requires_grad_(True)
        self._lookup = SparseLookup(rows=rows, ids=ids, aux=self._find_presort_aux(batch))
        return rows

    def sorted_slot_grads(self, ids: torch.Tensor, grads: torch.Tensor):
        """The sparse update's stream of a lookup (its ``ids`` and its leaf's
        gradient ``grads``, of the global batch under a split data axis):
        ``(M,)`` id-sorted int32 ids and their ``(M, E)`` gradients.  A
        negative id in ``[-rows, 0)`` was read from row ``rows + id`` of the
        logical view (``jnp.take``'s rule): its update goes there too."""
        rows = self.logical_rows()
        b, e = ids.shape[0], grads.shape[-1]
        ids = torch.where(ids < 0, ids + rows, ids)
        return sort_slot_grads(ids.reshape(b, -1), grads.reshape(b, -1, e))

    def _find_presort_aux(self, batch: Optional[Batch]) -> Optional[Dict]:
        """This module's presort aux in the batch, if the pipeline attached it."""
        from torecsys_tpu_torch.data.presort import AUX_NAMES, spec_for_module

        spec = spec_for_module(self)
        if batch is None or spec.aux_key("order") not in batch:
            return None
        return {name: batch[spec.aux_key(name)] for name in AUX_NAMES}

    def take_lookup(self) -> Optional[SparseLookup]:
        """Hand the step's recorded lookup over and clear it."""
        lookup, self._lookup = self._lookup, None
        return lookup


class SingleIndexEmbedding(TableInput):
    """One unpacked ``(field_size, E)`` table for one categorical field (or
    several fields sharing it) → ``(B, k, E)``, ``k`` the number of fields.

    Drawn from N(0, 0.01²), or copied from ``pretrained`` (a
    ``(field_size, E)`` array), as in the JAX package.
    """

    def __init__(self, field_size: int, embed_size: int, fields: Sequence[str],
                 pretrained: Optional[np.ndarray] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.field_size = int(field_size)
        self.embed_size = int(embed_size)
        self.fields = tuple(fields)
        self.pretrained = pretrained
        self._init_table((self.field_size, self.embed_size), dev)
        self.reset_parameters(default_generator(dev, generator=generator))

    def _draw(self, table, generator) -> None:
        if self.pretrained is not None:
            table.copy_(torch.as_tensor(np.asarray(self.pretrained), dtype=torch.float32))
        else:
            table.normal_(0.0, 0.01, generator=generator)

    def output_shape(self) -> Tuple[int, int]:
        return len(self.fields), self.embed_size

    def forward(self, batch: Batch) -> torch.Tensor:
        ids = self._stack_fields(batch, self.fields).to(torch.int64)  # (B, k)
        return self._lookup_rows(ids, batch)


class MultiIndicesEmbedding(TableInput):
    """Fused embedding over several categorical fields → ``(B, N, E)``.

    One packed table ``embedding`` of ``sum(field_sizes)`` logical rows; raw
    per-field ids are shifted by static offsets before one gather.
    ``flatten=True`` reshapes the output to ``(B, 1, N*E)``.  The table is
    float32, or bfloat16 on the dense route (:meth:`set_table_dtype`); the
    output is float32 either way.
    """

    def __init__(self, embed_size: int, field_sizes: Sequence[int], fields: Sequence[str],
                 flatten: bool = False, init_std: float = 0.01,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if len(fields) != len(field_sizes):
            raise ValueError(
                f"fields ({len(fields)}) and field_sizes ({len(field_sizes)}) must align"
            )
        dev = resolve_device(device)
        self.embed_size = int(embed_size)
        self.field_sizes = tuple(int(v) for v in field_sizes)
        self.fields = tuple(fields)
        self.flatten = flatten
        self.init_std = init_std
        self._init_table(packed_shape(int(sum(self.field_sizes)), self.embed_size), dev)
        self.register_buffer(
            "offsets",
            torch.as_tensor(field_offsets(self.field_sizes), dtype=torch.int64, device=dev),
            persistent=False,
        )
        self.reset_parameters(default_generator(dev, generator=generator))

    def _draw(self, table, generator) -> None:
        table.normal_(0.0, self.init_std, generator=generator)

    def output_shape(self) -> Tuple[int, int]:
        n = len(self.fields)
        return (1, n * self.embed_size) if self.flatten else (n, self.embed_size)

    def forward(self, batch: Batch) -> torch.Tensor:
        ids = self._stack_fields(batch, self.fields)  # (B, N)
        out = self.embed(ids, batch)
        if self.flatten:
            out = out.reshape(out.shape[0], 1, -1)
        return out

    def embed(self, ids: torch.Tensor, batch: Optional[Batch] = None) -> torch.Tensor:
        """Lookup of raw per-field ids ``(B, N) → (B, N, E)``."""
        return self._lookup_rows(ids.to(torch.int64) + self.offsets[None, :], batch)


class MultiIndicesFieldAwareEmbedding(TableInput):
    """Field-aware (FFM) embedding → ``(B, N*N, E)``: output entry ``i*N +
    j`` is field ``j``'s row in field-aware table ``i``.

    N logical tables of ``sum(field_sizes)`` rows each, stored packed as one
    ``(N, Vp, P*E)`` parameter, drawn from flax's ``xavier_uniform`` with the
    logical ``(V, E)`` fans.  Both routes look up the flat ``(N*Vp*P, E)``
    logical view with the global ids ``i*Vp*P + shifted[:, j]``, the ids the
    JAX package's sparse route sows, in one gather; on its dense route the
    JAX package gathers each table and transposes the result into the same
    order.  ``flatten=True`` → ``(B, 1, N*N*E)``.
    """

    def __init__(self, embed_size: int, field_sizes: Sequence[int], fields: Sequence[str],
                 flatten: bool = False, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if len(fields) != len(field_sizes):
            raise ValueError(
                f"fields ({len(fields)}) and field_sizes ({len(field_sizes)}) must align"
            )
        dev = resolve_device(device)
        self.embed_size = int(embed_size)
        self.field_sizes = tuple(int(v) for v in field_sizes)
        self.fields = tuple(fields)
        self.flatten = flatten
        n = len(self.field_sizes)
        vp, w = packed_shape(int(sum(self.field_sizes)), self.embed_size)
        self._init_table((n, vp, w), dev)
        rows_per_table = vp * (w // self.embed_size)
        self.register_buffer(
            "offsets",  # (N, N): table i, field j
            torch.as_tensor(field_offsets(self.field_sizes), dtype=torch.int64, device=dev)[None]
            + torch.arange(n, dtype=torch.int64, device=dev)[:, None] * rows_per_table,
            persistent=False,
        )
        self.reset_parameters(default_generator(dev, generator=generator))

    def _draw(self, table, generator) -> None:
        limit = math.sqrt(6.0 / (sum(self.field_sizes) + self.embed_size))
        table.uniform_(-limit, limit, generator=generator)

    def output_shape(self) -> Tuple[int, int]:
        n = len(self.fields)
        return (1, n * n * self.embed_size) if self.flatten else (n * n, self.embed_size)

    def forward(self, batch: Batch) -> torch.Tensor:
        ids = self._stack_fields(batch, self.fields).to(torch.int64)  # (B, N)
        b, n = ids.shape
        gids = ids[:, None, :] + self.offsets[None]  # (B, Ntab, Nfield)
        out = self._lookup_rows(gids, batch).reshape(b, n * n, self.embed_size)
        if self.flatten:
            out = out.reshape(b, 1, -1)
        return out


TABLE_BLOCK_ROWS = 1 << 21  # logical rows a block of a multi-hot table's draw
_BLOCK_SEED_MIX = 0x9E3779B97F4A7C15


class MultiHotIndicesEmbedding(TableInput):
    """Fused embedding over multi-hot categorical fields → ``(B, N, E)`` bag
    sums: field ``i`` reads ``(B, hots[i])`` ids (a ``(B,)`` field at one
    hot), shifted into one packed table of ``sum(field_sizes)`` logical rows
    as :class:`MultiIndicesEmbedding` shifts them, and each field's bag of
    rows is summed (``ops.embedding.pooled_lookup``: one
    ``pooled_row_gather`` kernel, no ``(B, S, E)`` rows in between).  An id
    outside the table adds nothing, and its slot takes no update.  Float32
    table and sums; it has no presort (the sparse route sorts on the
    device).  Under a mesh the lookup takes the psum strategy alone
    (``parallel.lookup.maybe_sharded_pooled_lookup``).

    **Shard-local table.**  The table is drawn in blocks of
    :data:`TABLE_BLOCK_ROWS` logical rows, N(0, ``init_std``²), block ``k``
    from its own generator seeded by ``k`` and one number drawn from the
    generator :meth:`reset_parameters` is given, so the logical table is the
    same whoever draws it.  :meth:`reset_parameters` allocates the table
    (this rank's rows of it where ``parallel.sharding`` laid it out, a
    ``row_layout``) and draws those rows alone, a block at a time; the
    Trainer lays the table out before it draws (``Trainer.init_state``), so
    no rank of a mesh holds more than its rows and one block.  Until then
    the table is unallocated (on the ``meta`` device): a module used without
    a Trainer is drawn by calling :meth:`reset_parameters`.
    """

    def __init__(self, embed_size: int, field_sizes: Sequence[int], hots: Sequence[int],
                 fields: Sequence[str], init_std: float = 0.01, device: DeviceLike = None):
        super().__init__()
        if not len(fields) == len(field_sizes) == len(hots):
            raise ValueError(f"fields ({len(fields)}), field_sizes ({len(field_sizes)}) and "
                             f"hots ({len(hots)}) must align")
        if any(int(h) < 1 for h in hots):
            raise ValueError(f"every field takes at least one id, got hots {tuple(hots)}")
        dev = resolve_device(device)
        self.embed_size = int(embed_size)
        self.field_sizes = tuple(int(v) for v in field_sizes)
        self.hots = tuple(int(h) for h in hots)
        self.fields = tuple(fields)
        self.init_std = init_std
        self._init_table(self.global_shape, "meta")
        offsets = np.repeat(field_offsets(self.field_sizes).astype(np.int64), self.hots)
        self.register_buffer("offsets", torch.as_tensor(offsets, device=dev), persistent=False)
        self.register_buffer("starts", torch.as_tensor(bag_starts(self.hots), device=dev),
                             persistent=False)
        self.register_buffer("bags", torch.as_tensor(slot_bags(self.hots), device=dev),
                             persistent=False)

    @property
    def global_shape(self) -> Tuple[int, int]:
        return packed_shape(sum(self.field_sizes), self.embed_size)

    @property
    def device(self) -> torch.device:
        """Where the table is (or will be) allocated: the buffers' device."""
        return self.offsets.device

    def _apply(self, fn, recurse=True):
        # an unallocated table stays so when the module moves (``.to``)
        if not self.embedding.is_meta:
            return super()._apply(fn, recurse)
        table = self._parameters.pop("embedding")
        try:
            return super()._apply(fn, recurse)
        finally:
            self._parameters["embedding"] = table

    def set_table_dtype(self, dtype: torch.dtype) -> None:
        if dtype != torch.float32:
            raise ValueError(f"MultiHotIndicesEmbedding keeps a float32 table, got {dtype}")

    def reset_parameters(self, generator=None) -> None:
        """Draw this rank's rows of the table (all of them without a layout),
        block by block (see the class docstring), allocating them first where
        they are not (``parallel.sharding.allocated_table``)."""
        if generator is None:
            generator = default_generator(self.device)
        seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                                 device=generator.device).item())
        vp, w = self.global_shape
        lay = self.row_layout
        first, count = (0, vp) if lay is None else (lay.index * lay.shard_rows, lay.shard_rows)
        pack, e = w // self.embed_size, self.embed_size
        logical = allocated_table(self, self.device).detach().view(-1, e)
        lo, hi = first * pack, (first + count) * pack
        total = sum(self.field_sizes)
        logical[max(0, total - lo):].zero_()  # the last stored row's padding
        for block in range(lo // TABLE_BLOCK_ROWS, -(-min(hi, total) // TABLE_BLOCK_ROWS)):
            b0 = block * TABLE_BLOCK_ROWS
            n = min(TABLE_BLOCK_ROWS, total - b0)
            gen = torch.Generator(device=self.device).manual_seed(
                (seed + (block + 1) * _BLOCK_SEED_MIX) & ((1 << 63) - 1))
            drawn = torch.empty((n, e), dtype=torch.float32, device=self.device)
            drawn.normal_(0.0, self.init_std, generator=gen)
            a, b = max(b0, lo), min(b0 + n, hi)
            logical[a - lo:b - lo].copy_(drawn[a - b0:b - b0])
            del drawn

    def output_shape(self) -> Tuple[int, int]:
        return len(self.fields), self.embed_size

    def _gather(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        trace.count("ids", ids.numel())
        trace.count("bags", ids.shape[0] * len(self.fields))
        return maybe_sharded_pooled_lookup(table, ids, self.starts, self.bags, self.embed_size,
                                           self.row_layout)

    def _find_presort_aux(self, batch: Optional[Batch]) -> Optional[Dict]:
        return None

    def sorted_slot_grads(self, ids: torch.Tensor, grads: torch.Tensor):
        """Each ``(B, S)`` slot takes its bag's gradient of the ``(B, N, E)``
        ``grads`` (``ops.sparse.sort_bag_grads``); an id outside the table
        added nothing, and updates no row: it becomes the sentinel
        ``rows``."""
        rows = self.logical_rows()
        ids = torch.where((ids >= 0) & (ids < rows), ids, rows)
        return sort_bag_grads(ids, grads, self.bags)

    def forward(self, batch: Batch) -> torch.Tensor:
        ids = self._stack_fields(batch, self.fields)  # (B, S)
        if ids.shape[1] != self.offsets.shape[0]:
            raise ValueError(f"the fields give {ids.shape[1]} ids an example, the hots "
                             f"{self.hots} say {self.offsets.shape[0]}")
        return self._lookup_rows(ids.to(torch.int64) + self.offsets[None, :], batch)


class _Container(BaseInput):
    """An input whose children are other inputs, in order."""

    def __init__(self, inputs: Sequence[BaseInput]):
        super().__init__()
        self.inputs = nn.ModuleList(inputs)

    def reset_parameters(self, generator=None) -> None:
        for m in self.inputs:
            m.reset_parameters(generator)

    def __getitem__(self, idx):
        """A child by position, or the child that reads raw field ``idx``."""
        if isinstance(idx, str):
            for m in self.inputs:
                if idx in getattr(m, "fields", ()):
                    return m
            raise KeyError(idx)
        return self.inputs[idx]


class ConcatInput(_Container):
    """Concatenate the children along the embedding axis, each flattened to
    ``(B, 1, N_i*E_i)`` → ``(B, 1, Σ N_i*E_i)``.  ``embed_size`` is the sum
    of the children's, as in the JAX package."""

    @property
    def embed_size(self) -> int:
        return sum(m.embed_size for m in self.inputs)

    def output_shape(self) -> Tuple[int, int]:
        return 1, sum(math.prod(m.output_shape()) for m in self.inputs)

    def forward(self, batch: Batch) -> torch.Tensor:
        outs = [m(batch) for m in self.inputs]
        return torch.cat([o.reshape(o.shape[0], 1, -1) for o in outs], dim=2)


class StackedInput(_Container):
    """Stack the children along the field axis → ``(B, Σ N_i, E)``; every
    child must emit the same ``E``."""

    @property
    def embed_size(self) -> int:
        sizes = {m.embed_size for m in self.inputs}
        if len(sizes) != 1:
            raise ValueError(f"StackedInput children disagree on embed size: {sizes}")
        return sizes.pop()

    def output_shape(self) -> Tuple[int, int]:
        return sum(m.output_shape()[0] for m in self.inputs), self.embed_size

    def forward(self, batch: Batch) -> torch.Tensor:
        return torch.cat([m(batch) for m in self.inputs], dim=1)


__all__ = ["ConcatInput", "MultiHotIndicesEmbedding", "MultiIndicesEmbedding",
           "MultiIndicesFieldAwareEmbedding", "SingleIndexEmbedding", "SparseLookup",
           "StackedInput", "TableInput", "ValueInput"]
