"""Categorical / value input modules (the embedding front-end).

Counterpart of ``torecsys_tpu/inputs/embeddings.py``: :class:`ValueInput`
and :class:`MultiIndicesEmbedding`, the fused table of several categorical
fields with per-field offsets, stored packed (``ops.embedding``).

The sparse route.  In flax, ``perturb`` and ``sow`` let the train step take
per-slot gradients and read back the ids.  Here a module with
``sparse_grads`` set, running with autograd on, gathers its rows from the
detached table and returns them as a fresh leaf tensor that requires grad;
it records that leaf, the shifted ids and the batch's presort aux as one
:class:`SparseLookup`, which the train step takes back with
:meth:`MultiIndicesEmbedding.take_lookup` after ``loss.backward()``.  A
second application before the lookup is taken raises: its gradient would be
summed against one call site's ids.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from torecsys_tpu_torch.inputs.base import BaseInput, Batch
from torecsys_tpu_torch.ops.embedding import field_offsets, packed_lookup, packed_shape
from torecsys_tpu_torch.utils import DeviceLike, default_generator, resolve_device


@dataclasses.dataclass
class SparseLookup:
    """One sparse-route lookup: the leaf ``rows`` whose ``.grad`` is the
    per-slot table gradient, the shifted ``ids`` and the presort ``aux``
    (None when the batch carries none)."""

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


class MultiIndicesEmbedding(BaseInput):
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
        shape = packed_shape(int(sum(self.field_sizes)), self.embed_size)
        self.embedding = nn.Parameter(torch.empty(shape, dtype=torch.float32, device=dev))
        self.register_buffer(
            "offsets",
            torch.as_tensor(field_offsets(self.field_sizes), dtype=torch.int64, device=dev),
            persistent=False,
        )
        self.sparse_grads = False
        self._lookup: Optional[SparseLookup] = None
        self.reset_parameters(default_generator(dev, generator=generator))

    def reset_parameters(self, generator=None) -> None:
        """Draw the table in float32 and store it in its dtype (a bf16 table
        holds the float32 draw rounded)."""
        with torch.no_grad():
            if self.embedding.dtype == torch.float32:
                self.embedding.normal_(0.0, self.init_std, generator=generator)
            else:
                drawn = torch.empty(self.embedding.shape, dtype=torch.float32,
                                    device=self.embedding.device)
                self.embedding.copy_(drawn.normal_(0.0, self.init_std, generator=generator))

    def set_table_dtype(self, dtype: torch.dtype) -> None:
        """Store the table in ``dtype`` (float32 or bfloat16; the pipeline's
        ``set_table_dtype``); its values are rounded to it."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"table dtype must be float32 or bfloat16, got {dtype}")
        if self.embedding.dtype != dtype:
            self.embedding = nn.Parameter(self.embedding.detach().to(dtype))

    @property
    def pack(self) -> int:
        return self.embedding.shape[1] // self.embed_size

    def forward(self, batch: Batch) -> torch.Tensor:
        ids = self._stack_fields(batch, self.fields)  # (B, N)
        out = self.embed(ids, batch)
        if self.flatten:
            out = out.reshape(out.shape[0], 1, -1)
        return out

    def embed(self, ids: torch.Tensor, batch: Optional[Batch] = None) -> torch.Tensor:
        """Lookup of raw per-field ids ``(B, N) → (B, N, E)``."""
        shifted = ids.to(torch.int64) + self.offsets[None, :]
        if not (self.sparse_grads and torch.is_grad_enabled()):
            # rows of a bf16 table are cast to float32 here, at the module
            # boundary: the model and the loss see float32
            return packed_lookup(self.embedding, shifted, self.embed_size).float()
        if self._lookup is not None:
            raise RuntimeError(
                "MultiIndicesEmbedding applied twice in one step: sparse embedding "
                "gradients need exactly one lookup per module per step"
            )
        rows = packed_lookup(self.embedding.detach(), shifted, self.embed_size)
        rows.requires_grad_(True)
        self._lookup = SparseLookup(rows=rows, ids=shifted, aux=self._find_presort_aux(batch))
        return rows

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


__all__ = ["MultiIndicesEmbedding", "SparseLookup", "ValueInput"]
