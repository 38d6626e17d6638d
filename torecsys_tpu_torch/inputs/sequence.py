"""List and sequence inputs: behaviour histories (counterpart of
``torecsys_tpu/inputs/sequence.py``).

* :class:`ListIndicesEmbedding` — an unordered id list ``(B, L)``: looked
  up, optionally through multi-head self-attention over the list's valid
  keys, then pooled;
* :class:`SequenceIndicesEmbedding` — an ordered id sequence: looked up,
  through stacked recurrent layers (``layers.rnn``: flax's LSTM, GRU or
  simple cells, optionally bidirectional and projected back to E), then
  pooled.

Sequences have a fixed length L with a validity mask: from ``lengths_field``
(a ``(B,)`` field of the batch) where it is given and present, else from
``ids != padding_idx``.  Each table is one ``(field_size, E)`` parameter,
``embedding``, drawn from N(0, 0.01²), looked up through ``row_gather``
(``ops.embedding.packed_lookup``) and differentiated through
``table_grad``.  These are not table modules of the sparse route
(``inputs.embeddings.TableInput``): as in the JAX package, whose presort
gives them no spec, their tables stay on the dense optimizer when the
pipeline is on the sparse route.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from torecsys_tpu_torch.inputs.base import BaseInput, Batch
from torecsys_tpu_torch.layers.ctr.attention import MultiHeadDotProductAttention
from torecsys_tpu_torch.layers.ctr.dense import Dense
from torecsys_tpu_torch.layers.rnn import CELLS, RNN, Bidirectional
from torecsys_tpu_torch.parallel.lookup import maybe_sharded_packed_lookup
from torecsys_tpu_torch.parallel.sharding import draw_table
from torecsys_tpu_torch.utils import DeviceLike, default_generator, resolve_device

OUTPUT_METHODS = ("avg_pooling", "mean", "max_pooling", "sum", "none")


def _length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """``(B,)`` lengths → ``(B, L)`` boolean validity mask."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return pos < lengths[:, None]


def _aggregate(x: torch.Tensor, mask: Optional[torch.Tensor], output_method: str) -> torch.Tensor:
    """Pool ``(B, L, E)`` over L by ``output_method`` (``mask`` ``(B, L)``):
    the masked positions are zeroed first; ``none`` returns the masked
    ``(B, L, E)``, the others ``(B, 1, E)``: ``avg_pooling``/``mean`` the
    sum over the valid count (at least 1), ``max_pooling`` with the masked
    positions at ``finfo.min``, ``sum``."""
    if mask is not None:
        x = torch.where(mask[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    if output_method == "none":
        return x
    if output_method in ("avg_pooling", "mean"):
        if mask is None:
            return torch.mean(x, dim=1, keepdim=True)
        denom = torch.clamp(torch.sum(mask, dim=1), min=1)[:, None, None].to(x.dtype)
        return torch.sum(x, dim=1, keepdim=True) / denom
    if output_method == "max_pooling":
        if mask is not None:
            x = torch.where(mask[..., None], x, torch.finfo(x.dtype).min)
        return torch.amax(x, dim=1, keepdim=True)
    if output_method == "sum":
        return torch.sum(x, dim=1, keepdim=True)
    raise ValueError(f"unknown output_method {output_method!r}")


class _SequenceTable(BaseInput):
    """The ``(field_size, E)`` table both inputs share, and their ids."""

    def __init__(self, field_size: int, embed_size: int, fields: Sequence[str],
                 output_method: str, device: torch.device):
        super().__init__()
        if output_method not in OUTPUT_METHODS:
            raise ValueError(f"unknown output_method {output_method!r}")
        self.field_size = int(field_size)
        self.embed_size = int(embed_size)
        self.fields = tuple(fields)
        self.output_method = output_method
        self.embedding = nn.Parameter(torch.empty(self.field_size, self.embed_size,
                                                  device=device))
        self.row_layout = None  # this rank's rows when the table is row-sharded

    def reset_parameters(self, generator=None) -> None:
        # under a row_layout, this rank's rows of the whole table's draw
        draw_table(self, lambda t, g: t.normal_(0.0, 0.01, generator=g), generator)

    def output_shape(self) -> Tuple[int, int]:
        if self.output_method == "none":
            raise ValueError(f"{type(self).__name__} with output_method 'none' emits (B, L, E): "
                             "L is the batch's")
        return 1, self.embed_size

    def _ids(self, batch: Batch) -> torch.Tensor:
        ids = batch[self.fields[0]]
        return ids[:, None] if ids.dim() == 1 else ids

    def _lookup(self, ids: torch.Tensor) -> torch.Tensor:
        return maybe_sharded_packed_lookup(self.embedding, ids.to(torch.int64), self.embed_size,
                                           self.row_layout)


class ListIndicesEmbedding(_SequenceTable):
    """Unordered id list ``(B, L)`` → ``(B, 1, E)`` pooled (or ``(B, L,
    E)`` with ``output_method="none"``).

    With ``use_attn``, the looked-up list goes through flax's multi-head
    self-attention (``num_heads``, ``qkv_features = E``, ``dropout_rate``
    in training), each query attending to the list's valid keys (a ``(B,
    1, L, L)`` mask); the submodule keeps flax's automatic name,
    ``MultiHeadDotProductAttention_0``, and computes in float32 under any
    pipeline compute dtype, as the JAX package builds it without
    ``dtype=``.
    """

    def __init__(self, field_size: int, embed_size: int, fields: Sequence[str],
                 padding_idx: Optional[int] = 0, use_attn: bool = False, num_heads: int = 1,
                 dropout_rate: float = 0.0, output_method: str = "avg_pooling",
                 lengths_field: Optional[str] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        dev = resolve_device(device)
        super().__init__(field_size, embed_size, fields, output_method, dev)
        self.padding_idx = padding_idx
        self.lengths_field = lengths_field
        self.use_attn = use_attn
        if use_attn:
            self.add_module("MultiHeadDotProductAttention_0", MultiHeadDotProductAttention(
                self.embed_size, num_heads, qkv_features=self.embed_size,
                dropout_rate=dropout_rate, follows_pipeline=False, device=dev))
        self.reset_parameters(default_generator(dev, generator=generator))

    @property
    def attention(self) -> Optional[MultiHeadDotProductAttention]:
        return getattr(self, "MultiHeadDotProductAttention_0", None)

    def reset_parameters(self, generator=None) -> None:
        super().reset_parameters(generator)
        if self.use_attn:
            self.attention.reset_parameters(generator)

    def forward(self, batch: Batch) -> torch.Tensor:
        ids = self._ids(batch)
        emb = self._lookup(ids)  # (B, L, E)
        mask = None
        if self.lengths_field is not None and self.lengths_field in batch:
            mask = _length_mask(batch[self.lengths_field], ids.shape[1])
        elif self.padding_idx is not None:
            mask = ids != self.padding_idx
        if self.use_attn:
            # (B, 1, L, L): a query may attend to any valid key
            attn_mask = None if mask is None else mask[:, None, None, :].expand(
                -1, 1, ids.shape[1], -1)
            emb = self.attention(emb, mask=attn_mask)
        return _aggregate(emb, mask, self.output_method)


class SequenceIndicesEmbedding(_SequenceTable):
    """Ordered id sequence ``(B, L)`` → ``(B, 1, E)`` pooled (or ``(B, L,
    E)``), through ``num_layers`` recurrent layers of ``rnn_method``
    (``lstm``: flax's ``OptimizedLSTMCell``, ``gru``, ``rnn``: its
    ``SimpleCell``) of E features, each an :class:`~torecsys_tpu_torch.layers.rnn.RNN`
    or, with ``bidirectional``, a :class:`~torecsys_tpu_torch.layers.rnn.Bidirectional`
    pair (its output 2E wide; ``bidir_proj``, a float32 Dense, maps the
    last back to E), all with the sequences' lengths.

    The lengths come from ``lengths_field`` where it is given and in the
    batch, else from ``ids != padding_idx``.  The cells keep flax's names
    in this module's scope, in creation order: ``<Cell>_<2i>`` forward and
    ``<Cell>_<2i+1>`` backward for layer ``i`` of a bidirectional stack,
    ``<Cell>_<i>`` otherwise.
    """

    def __init__(self, field_size: int, embed_size: int, fields: Sequence[str],
                 lengths_field: Optional[str] = None, rnn_method: str = "lstm",
                 bidirectional: bool = False, num_layers: int = 1,
                 output_method: str = "avg_pooling", padding_idx: int = 0,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        dev = resolve_device(device)
        super().__init__(field_size, embed_size, fields, output_method, dev)
        if rnn_method not in CELLS:
            raise ValueError(f"unknown rnn_method {rnn_method!r}")
        self.lengths_field = lengths_field
        self.rnn_method = rnn_method
        self.bidirectional = bidirectional
        self.num_layers = num_layers
        self.padding_idx = padding_idx
        cell_cls = CELLS[rnn_method]
        e = self.embed_size
        self.cell_names = []
        for i in range(num_layers):
            width = e if i == 0 else (2 * e if bidirectional else e)
            for _ in range(2 if bidirectional else 1):
                name = f"{cell_cls.__name__}_{len(self.cell_names)}"
                self.add_module(name, cell_cls(width, e, device=dev))
                self.cell_names.append(name)
        self.bidir_proj = (Dense(2 * e, e, follows_pipeline=False, device=dev)
                           if bidirectional else None)
        self.reset_parameters(default_generator(dev, generator=generator))

    def reset_parameters(self, generator=None) -> None:
        super().reset_parameters(generator)
        for name in self.cell_names:
            getattr(self, name).reset_parameters(generator)
        if self.bidir_proj is not None:
            self.bidir_proj.reset_parameters(generator)

    def _layers(self):
        cells = [getattr(self, n) for n in self.cell_names]
        if self.bidirectional:
            return [Bidirectional(RNN(f), RNN(b)) for f, b in zip(cells[::2], cells[1::2])]
        return [RNN(c) for c in cells]

    def forward(self, batch: Batch) -> torch.Tensor:
        ids = self._ids(batch)
        x = self._lookup(ids)  # (B, L, E)
        if self.lengths_field is not None and self.lengths_field in batch:
            lengths = batch[self.lengths_field].to(torch.int32)
        else:
            lengths = torch.sum(ids != self.padding_idx, dim=1, dtype=torch.int32)
        mask = _length_mask(lengths, ids.shape[1])
        for layer in self._layers():
            x = layer(x, seq_lengths=lengths)
        if self.bidir_proj is not None:
            x = self.bidir_proj(x)
        return _aggregate(x, mask, self.output_method)


__all__ = ["ListIndicesEmbedding", "OUTPUT_METHODS", "SequenceIndicesEmbedding"]
