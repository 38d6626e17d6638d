"""Batches packed into one flat byte buffer, for one copy to the card.

A host batch is a dict of numpy arrays: the feature columns, the label and,
on the presorted route, the presort aux.  :class:`BatchLayout` places every
array of a batch at a 16-byte-aligned offset of one ``uint8`` row, so a
group of ``n`` batches of the same layout is one ``(n, nbytes)`` buffer: the
prefetch workers pack it (pinned where the card will read it) and the
training loop moves it to the card with one non-blocking copy.
:meth:`BatchLayout.unpack` turns a row, on either side, back into a dict of
tensors that are views of it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

ALIGN = 16


@dataclasses.dataclass(frozen=True)
class BatchLayout:
    """Where each array of a batch lies in its packed row."""

    keys: Tuple[str, ...]
    dtypes: Tuple[np.dtype, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    offsets: Tuple[int, ...]
    nbytes: int
    sizes: Tuple[int, ...] = dataclasses.field(init=False, compare=False)
    torch_dtypes: Tuple[torch.dtype, ...] = dataclasses.field(init=False, compare=False)

    def __post_init__(self):
        sizes = tuple(int(np.prod(s, dtype=np.int64)) * d.itemsize
                      for d, s in zip(self.dtypes, self.shapes))
        object.__setattr__(self, "sizes", sizes)
        object.__setattr__(self, "torch_dtypes",
                           tuple(torch.from_numpy(np.empty(0, d)).dtype for d in self.dtypes))

    @classmethod
    def of(cls, batch: Dict[str, np.ndarray]) -> "BatchLayout":
        keys = tuple(sorted(batch))
        arrays = [np.asarray(batch[k]) for k in keys]
        offsets, at = [], 0
        for a in arrays:
            offsets.append(at)
            at += -(-a.nbytes // ALIGN) * ALIGN
        return cls(keys, tuple(a.dtype for a in arrays), tuple(a.shape for a in arrays),
                   tuple(offsets), max(at, ALIGN))

    def fits(self, batch: Dict[str, np.ndarray]) -> bool:
        return (tuple(sorted(batch)) == self.keys
                and all(np.asarray(batch[k]).dtype == d and np.shape(batch[k]) == s
                        for k, d, s in zip(self.keys, self.dtypes, self.shapes)))

    def pack(self, batches: Sequence[Dict[str, np.ndarray]], pin: bool) -> torch.Tensor:
        """``(len(batches), nbytes)`` uint8 holding ``batches`` in order;
        page-locked where ``pin`` (for a non-blocking copy to the card)."""
        buf = torch.empty((len(batches), self.nbytes), dtype=torch.uint8, pin_memory=pin)
        rows = buf.numpy()
        for key, dtype, shape, off, n in zip(self.keys, self.dtypes, self.shapes,
                                             self.offsets, self.sizes):
            # one copy per key for the whole group: a strided view of the rows
            dst = rows[:, off:off + n].view(dtype)
            dst.shape = (len(batches), *shape)  # raises rather than copy
            np.stack([batch[key] for batch in batches], out=dst, casting="no")
        return buf

    def unpack(self, row: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The batch in one packed ``(nbytes,)`` uint8 row, as tensors that
        are views of it, on the row's device."""
        return {key: row[off:off + n].view(dtype).view(shape)
                for key, dtype, shape, off, n in zip(self.keys, self.torch_dtypes, self.shapes,
                                                     self.offsets, self.sizes)}


def group_batches(batches, size: int):
    """Consecutive batches in groups of up to ``size`` that share one
    layout: a group closes when it is full or when the next batch's keys,
    dtypes or shapes differ (it then opens the next group)."""
    group: List[Dict[str, np.ndarray]] = []
    layout = None
    for batch in batches:
        if group and (len(group) == size or not layout.fits(batch)):
            yield group
            group = []
        if not group:
            layout = BatchLayout.of(batch)
        group.append(batch)
    if group:
        yield group


__all__ = ["ALIGN", "BatchLayout", "group_batches"]
