"""Host-side id-stream preprocessing for the sparse embedding train path.

The port's own copy of ``torecsys_tpu/data/presort.py``.  All of a batch's
id preprocessing depends only on its integer ids, which the host holds
before the step: the sort order, the in-row slot of each sorted
id, its stored-row segment, the compact unique stored-row ids and their
count.  :class:`Presorter` computes them and attaches them to the batch
under ``__presort__<key>/<name>``; the consuming embedding module derives the
same key from its own schema (:meth:`PresortSpec.key`, a content hash that
equals the JAX package's for the same schema).

Two routes give the same bits: the C++ radix presort (``data/native``,
``trs_presort_ids``), built with ``g++`` at first use and called with the
interpreter lock released, so prefetch worker threads presort in parallel;
and numpy's stable argsort, taken where no compiler works (a warning is
logged) or when asked for with ``force_numpy``.

Unlike the reference, the Presorter refuses a batch it cannot describe
before the trusted device route sees it: an empty id stream, or an id
outside the table's logical rows, raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

AUX_PREFIX = "__presort__"
AUX_NAMES = ("order", "lo", "seg", "uids", "n_unique")


@dataclasses.dataclass(frozen=True)
class PresortSpec:
    """One embedding module's fused id stream: ``slot_fields[i]`` feeds slot
    ``i`` of the ``(B, K)`` id matrix, shifted by ``slot_offsets[i]``; ids
    resolve against a packed table of ``num_stored_rows`` rows of ``pack``
    logical rows each, of which the first ``num_rows`` are the table's.

    ``num_rows`` bounds the ids the Presorter accepts; it is not part of
    :attr:`key`, which hashes the JAX package's four fields."""

    slot_fields: Tuple[str, ...]
    slot_offsets: Tuple[int, ...]
    pack: int
    num_stored_rows: int
    num_rows: int

    @property
    def key(self) -> str:
        ident = repr((self.slot_fields, self.slot_offsets, self.pack,
                      self.num_stored_rows)).encode()
        return hashlib.sha1(ident).hexdigest()[:12]

    def aux_key(self, name: str) -> str:
        return f"{AUX_PREFIX}{self.key}/{name}"


def spec_for_module(module) -> Optional[PresortSpec]:
    """The spec of one of the port's table modules, or None when the module
    has no host-presortable id stream."""
    from torecsys_tpu_torch.inputs.embeddings import (
        MultiIndicesEmbedding,
        MultiIndicesFieldAwareEmbedding,
        SingleIndexEmbedding,
    )
    from torecsys_tpu_torch.ops.embedding import field_offsets, packed_shape

    if isinstance(module, MultiIndicesEmbedding):
        v = int(sum(module.field_sizes))
        vp, w = packed_shape(v, module.embed_size)
        return PresortSpec(
            slot_fields=tuple(module.fields),
            slot_offsets=tuple(int(o) for o in field_offsets(module.field_sizes)),
            pack=w // module.embed_size,
            num_stored_rows=vp,
            num_rows=v,
        )
    if isinstance(module, MultiIndicesFieldAwareEmbedding):
        # slot (i, j): field j in field-aware table i, at the flat logical id
        # shifted[j] + i * Vp * P (the module's lookup)
        n = len(module.field_sizes)
        vp, w = packed_shape(int(sum(module.field_sizes)), module.embed_size)
        pack = w // module.embed_size
        offs = field_offsets(module.field_sizes)
        return PresortSpec(
            slot_fields=tuple(module.fields[j] for i in range(n) for j in range(n)),
            slot_offsets=tuple(int(offs[j]) + i * vp * pack for i in range(n) for j in range(n)),
            pack=pack,
            num_stored_rows=n * vp,
            num_rows=n * vp * pack,
        )
    if isinstance(module, SingleIndexEmbedding):
        return PresortSpec(
            slot_fields=tuple(module.fields),
            slot_offsets=(0,) * len(module.fields),
            pack=1,
            num_stored_rows=module.field_size,
            num_rows=module.field_size,
        )
    return None


def iter_embedding_specs(inputs_module) -> Iterable[PresortSpec]:
    """The spec of every presortable table module under an inputs tree, the
    children of ``ConcatInput`` and ``StackedInput`` included."""
    for module in inputs_module.modules():
        spec = spec_for_module(module)
        if spec is not None:
            yield spec


def build_presort_specs(inputs_module) -> List[PresortSpec]:
    """All distinct specs under an ``Inputs`` tree (deduped by key)."""
    seen = {}
    for spec in iter_embedding_specs(inputs_module):
        seen.setdefault(spec.key, spec)
    return list(seen.values())


def _presort_numpy(flat: np.ndarray, pack: int, num_stored: int):
    """Stable ascending-id order and the segment aux of a flat id stream."""
    m = flat.shape[0]
    order = np.argsort(flat, kind="stable").astype(np.int32)
    s = flat[order]
    hi = s // pack
    lo = (s - hi * pack).astype(np.int32)
    first = np.empty(m, dtype=bool)
    first[0] = True
    np.not_equal(hi[1:], hi[:-1], out=first[1:])
    seg = np.cumsum(first, dtype=np.int32) - 1
    n_unique = int(seg[-1]) + 1
    uids = np.full(m, num_stored, np.int32)
    uids[:n_unique] = hi[first]
    return order, lo, seg, uids, n_unique


class Presorter:
    """Batch-dict transform attaching the trusted-presort aux arrays.

    Stateless per batch, so prefetch worker threads may call it at once.
    ``n_unique`` is attached as a ``(1,)`` int32 array as in the JAX
    package.  :attr:`native` says whether the C++ presort runs.

    Args:
        specs: the id streams to presort.
        force_numpy: presort with numpy even where the C++ presort builds.
    """

    def __init__(self, specs: Iterable[PresortSpec], force_numpy: bool = False):
        self.specs = list(specs)
        for spec in self.specs:
            if not 0 < spec.num_rows < 2**31 or not 0 < spec.num_stored_rows < 2**31:
                raise ValueError(f"presort spec {spec.key}: {spec.num_rows} rows in "
                                 f"{spec.num_stored_rows} stored rows do not fit int32 ids")
        self._lib = None
        if not force_numpy:
            from torecsys_tpu_torch.data.native import presort_lib

            self._lib = presort_lib()
        self._offs = {s.key: np.asarray(s.slot_offsets, np.int32) for s in self.specs}

    @property
    def native(self) -> bool:
        return self._lib is not None

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = dict(batch)
        for spec in self.specs:
            if any(f not in batch for f in spec.slot_fields):
                continue  # e.g. an eval batch lacking this stream's fields
            cols = [np.asarray(batch[f]).reshape(-1) for f in spec.slot_fields]
            stacked = np.stack(cols, axis=1)  # (B, K), the columns' own dtype
            if stacked.size == 0:
                raise ValueError(f"empty id stream for presort spec {spec.key}")
            if stacked.size >= 2**31:
                raise ValueError(f"id stream of {stacked.size} ids for presort spec "
                                 f"{spec.key} is too long for int32 positions")
            offs = self._offs[spec.key]
            # the fused ids' range in int64, from each slot's own min and max
            offs64 = offs.astype(np.int64)
            lo_id = int((stacked.min(axis=0).astype(np.int64) + offs64).min())
            hi_id = int((stacked.max(axis=0).astype(np.int64) + offs64).max())
            if lo_id < 0 or hi_id >= spec.num_rows:
                raise ValueError(
                    f"ids outside [0, {spec.num_rows}) for presort spec {spec.key}: "
                    f"min {lo_id}, max {hi_id}"
                )
            # every fused id lies in [0, num_rows) and num_rows < 2**31: int32
            # holds the raw ids and their sums with the offsets
            stacked = np.ascontiguousarray(stacked, dtype=np.int32)
            if self._lib is not None:
                order, lo, seg, uids, n_unique = self._presort_native(stacked, offs, spec)
            else:
                order, lo, seg, uids, n_unique = _presort_numpy(
                    (stacked + offs[None, :]).reshape(-1), spec.pack, spec.num_stored_rows
                )
            out[spec.aux_key("order")] = order
            out[spec.aux_key("lo")] = lo
            out[spec.aux_key("seg")] = seg
            out[spec.aux_key("uids")] = uids
            out[spec.aux_key("n_unique")] = np.full((1,), n_unique, np.int32)
        return out

    def _presort_native(self, stacked: np.ndarray, offs: np.ndarray, spec: PresortSpec):
        """``trs_presort_ids`` on a checked ``(B, K)`` int32 id matrix."""
        m, k = stacked.size, stacked.shape[1]
        order, lo, seg, uids = (np.empty(m, np.int32) for _ in range(4))
        p = ctypes.POINTER(ctypes.c_int32)
        n_unique = self._lib.trs_presort_ids(
            stacked.ctypes.data_as(p), m, k, offs.ctypes.data_as(p), spec.pack,
            spec.num_stored_rows, order.ctypes.data_as(p), lo.ctypes.data_as(p),
            seg.ctypes.data_as(p), uids.ctypes.data_as(p))
        if n_unique < 0:
            raise ValueError(f"native presort refused the batch for spec {spec.key}")
        return order, lo, seg, uids, int(n_unique)


def strip_aux(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Remove presort aux entries (e.g. before a dense-route step)."""
    return {k: v for k, v in batch.items() if not k.startswith(AUX_PREFIX)}


__all__ = ["AUX_NAMES", "AUX_PREFIX", "PresortSpec", "Presorter",
           "build_presort_specs", "iter_embedding_specs", "spec_for_module", "strip_aux"]
