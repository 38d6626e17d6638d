"""Schema-driven collation: rows → fixed-shape numpy batches, and a simple
batching DataLoader (counterpart of ``torecsys_tpu/data/collate.py``).

Three field types (``values`` / ``indices`` / ``images``), vocabulary-backed
index fields, padding of variable-length lists to a declared static
``max_length`` (every batch has one shape, so a CUDA graph of the step is
captured once), and a ``summary()``.  The loader drops the final partial
batch for the same reason.  Images load through PIL, imported when an image
path is first read.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from torecsys_tpu_torch.data.fields import IndexField


@dataclasses.dataclass
class FieldSpec:
    """One collation rule.

    Args:
        field_type: ``'values' | 'indices' | 'images'``.
        vocab: optional :class:`IndexField` applied to raw tokens
            (``indices`` fields; grown on the fly by ``fit_predict``).
        max_length: static list length for multi-valued ``indices`` fields
            (scalar fields leave it at 1).
        dtype: output dtype.
        transform: optional ``ndarray → ndarray`` applied per image after
            loading (``images`` fields).
    """

    field_type: str = "values"
    vocab: Optional[IndexField] = None
    max_length: int = 1
    dtype: Optional[np.dtype] = None
    transform: Optional[object] = None


class CollateFunction:
    """``{field: FieldSpec}`` schema → ``to_batch(rows) → {field: ndarray}``.

    ``values`` fields → float32 ``(B,)``; ``indices`` fields → int32 ``(B,)``
    (scalar) or ``(B, L)`` + ``f'{name}_lengths'`` ``(B,)`` (list); ``images``
    → float32 ``(B, H, W, C)`` stacked NHWC.
    """

    def __init__(self, schema: Dict[str, FieldSpec]):
        self.schema = dict(schema)

    def to_batch(self, rows: Sequence[Dict[str, object]]) -> Dict[str, np.ndarray]:
        batch: Dict[str, np.ndarray] = {}
        for name, spec in self.schema.items():
            col = [r[name] for r in rows]
            if spec.field_type == "values":
                batch[name] = np.asarray(col, dtype=spec.dtype or np.float32)
            elif spec.field_type == "indices":
                batch.update(self._collate_indices(name, col, spec))
            elif spec.field_type == "images":
                batch[name] = np.stack(
                    [self._load_image(x, spec) for x in col], axis=0
                )
            else:
                raise ValueError(f"unknown field_type {spec.field_type!r} for {name!r}")
        return batch

    @staticmethod
    def _load_image(x, spec: "FieldSpec") -> np.ndarray:
        """One image cell → float32 HWC array.

        Accepts an in-memory array, a filesystem path, or an http(s) URL
        (PIL opens paths and fetched bytes; PIL is imported here, and a
        clear ImportError is raised where it is missing).

        Scaling: every uint8 source is scaled to [0, 1], loaded images and
        in-memory integer arrays alike, so a dataset mixing paths with raw
        uint8 arrays feeds consistently scaled features.  Float arrays are
        taken as scaled already and pass through.
        """
        if isinstance(x, str):
            try:
                from PIL import Image
            except ImportError as e:
                raise ImportError("loading an image from a path or URL needs Pillow "
                                  "(the PIL package), which is not installed") from e

            if x.startswith(("http://", "https://")):
                import io
                import urllib.request

                with urllib.request.urlopen(  # pragma: no cover (network)
                    x, timeout=30
                ) as r:
                    img = Image.open(io.BytesIO(r.read()))
            else:
                img = Image.open(x)
            arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
        else:
            raw = np.asarray(x)
            arr = raw.astype(np.float32)
            if np.issubdtype(raw.dtype, np.integer):
                arr = arr / 255.0
        if spec.transform is not None:
            arr = np.asarray(spec.transform(arr), dtype=np.float32)
        return arr

    def _collate_indices(
        self, name: str, col: List[object], spec: FieldSpec
    ) -> Dict[str, np.ndarray]:
        is_list = len(col) > 0 and isinstance(col[0], (list, tuple, np.ndarray))
        if not is_list:
            if spec.vocab is not None:
                col = spec.vocab.fit_predict(col)
            return {name: np.asarray(col, dtype=spec.dtype or np.int32)}
        L = spec.max_length
        out = np.zeros((len(col), L), dtype=spec.dtype or np.int32)
        lengths = np.zeros((len(col),), dtype=np.int32)
        for i, lst in enumerate(col):
            lst = list(lst)[:L]
            if spec.vocab is not None:
                lst = spec.vocab.fit_predict(lst)
            out[i, : len(lst)] = lst
            lengths[i] = len(lst)
        return {name: out, f"{name}_lengths": lengths}

    def summary(self) -> str:
        """Tabular description of the schema."""
        lines = [f"{'field':24s} {'type':8s} {'max_len':8s} {'vocab':8s}"]
        for name, spec in self.schema.items():
            vocab = str(len(spec.vocab)) if spec.vocab is not None else "-"
            lines.append(
                f"{name:24s} {spec.field_type:8s} {spec.max_length!s:8s} {vocab:8s}"
            )
        return "\n".join(lines)


class DataLoader:
    """Minimal host-side batcher: dataset + collate → fixed-shape batches.

    ``drop_last=True`` (default) keeps every batch the same shape (a CUDA
    graph of the step takes one); ``shuffle`` uses a numpy PRNG seeded per
    epoch (``seed + epoch``).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Optional[CollateFunction] = None,
        shuffle: bool = False,
        drop_last: bool = True,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        self._epoch += 1
        stop = n - (n % self.batch_size) if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            idx = order[start : start + self.batch_size]
            rows = [self.dataset[int(i)] for i in idx]
            if self.collate_fn is not None:
                yield self.collate_fn.to_batch(rows)
            else:
                # rows of dicts → dict of arrays
                keys = rows[0].keys()
                yield {k: np.asarray([r[k] for r in rows]) for k in keys}
