"""Chunked, RAM-bounded streaming over Criteo DAC training files
(counterpart of ``torecsys_tpu/data/streaming.py``).

The file is read in line-aligned chunks; each chunk is parsed by the C++
Criteo parser (``data.native``), optionally shuffled (the chunk is the
shuffle buffer) and cut into batches of exactly ``batch_size`` rows, so peak
host memory is O(chunk), not O(file).

Several nodes: ``shard_index``/``num_shards`` (by default the node's
index and the number of nodes of the ``torch.distributed`` world, from
``LOCAL_WORLD_SIZE``, as ``torchrun`` sets it; 0 and 1 on one node or
without a process group) give each node every ``num_shards``-th chunk.  A
node is the JAX package's process: on one node every rank reads the whole
file, and the Trainer keeps each rank's slice of each batch.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from torecsys_tpu_torch.data.native import NUM_CATS, parse_criteo_tsv


def _process_shard() -> Tuple[int, int]:
    """(node index, nodes) of the ``torch.distributed`` world, (0, 1) on one
    node or without a process group."""
    from torecsys_tpu_torch.parallel.mesh import local_world_size, world

    rank, size = world()
    local = local_world_size()
    return rank // local, max(1, size // local)


def _columns(parsed: Dict[str, np.ndarray], target_fields: str) -> Dict[str, np.ndarray]:
    """Expand parser output to the CLI column convention
    (``label`` / ``dense_j`` / ``cat_i``)."""
    out = {target_fields: parsed["label"]}
    for j in range(parsed["dense"].shape[1]):
        out[f"dense_{j}"] = parsed["dense"][:, j]
    for i in range(parsed["cats"].shape[1]):
        out[f"cat_{i}"] = parsed["cats"][:, i]
    return out


class CriteoFileIterable:
    """Re-iterable chunked batch stream over a Criteo DAC TSV file.

    Each ``iter()`` is a fresh epoch.  Yields fixed-shape column dicts of
    exactly ``batch_size`` rows; rows carried across chunk boundaries are
    preserved, a final sub-batch-size remainder is dropped (every step of a
    CUDA graph takes the same shapes; the in-memory loaders drop it too).

    Args:
        path: TSV file path.
        hash_sizes: per-categorical-field hash modulus (26 entries).
        batch_size: rows per yielded batch.
        chunk_bytes: bytes read+parsed per chunk (the RAM bound and the
            shuffle-buffer size). Default 256 MB ≈ 1.4M Criteo rows.
        shuffle: shuffle rows within each chunk (epoch-seeded).
        seed: base shuffle seed; epoch ``e`` uses ``seed + e``.
        target_fields: name for the label column.
        shard_index / num_shards: this process's chunk stride; by default
            the ``torch.distributed`` rank and world size when a process
            group is initialised, else 0 and 1.
        drop_remainder: drop the final sub-batch-size rows (default True).
        sync_batches: with several shards (default True), truncate every
            shard's epoch to the smallest per-shard batch count, so all
            processes take the same number of steps.  Chunk ownership is
            strided and chunks hold unequal row counts, so without this the
            processes' loaders run out at different steps and their
            collectives hang.  The counts come from one newline-counting
            pass over the file (every process reads the whole byte stream
            to stride chunks, so each computes all shards' counts alone and
            arrives at the same minimum, with no collective), cached per
            (path, size, mtime).
    """

    def __init__(
        self,
        path: str,
        hash_sizes: Sequence[int],
        batch_size: int = 1024,
        chunk_bytes: int = 256 << 20,
        shuffle: bool = False,
        seed: int = 0,
        target_fields: str = "label",
        shard_index: Optional[int] = None,
        num_shards: Optional[int] = None,
        drop_remainder: bool = True,
        sync_batches: bool = True,
    ):
        if len(tuple(hash_sizes)) != NUM_CATS:
            raise ValueError(f"hash_sizes must have {NUM_CATS} entries")
        self.path = path
        self.hash_sizes = tuple(hash_sizes)
        self.batch_size = int(batch_size)
        self.chunk_bytes = max(int(chunk_bytes), 1 << 20)
        self.shuffle = shuffle
        self.seed = seed
        self.target_fields = target_fields
        self.drop_remainder = drop_remainder
        if shard_index is None or num_shards is None:
            shard_index, num_shards = _process_shard()
        if not (0 <= shard_index < num_shards):
            raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.sync_batches = sync_batches
        self._epoch = 0
        self._count_cache = None  # ((path, size, mtime), per-shard rows)

    # -- chunk reader ------------------------------------------------------

    def _all_chunks(self) -> Iterator[tuple]:
        """``(chunk_index, line-aligned bytes)`` for EVERY chunk of the file.
        The partial tail line of a chunk is carried into the next so no row
        is split or lost."""
        chunk_idx = 0
        with open(self.path, "rb") as f:
            tail = b""
            while True:
                buf = f.read(self.chunk_bytes)
                if not buf:
                    if tail:
                        yield chunk_idx, tail
                    return
                buf = tail + buf
                cut = buf.rfind(b"\n")
                if cut < 0:
                    tail = buf  # a single line longer than the chunk: keep reading
                    continue
                tail = buf[cut + 1:]
                yield chunk_idx, buf[: cut + 1]
                chunk_idx += 1

    def _chunks(self) -> Iterator[bytes]:
        """This shard's chunks: every ``num_shards``-th one by stride."""
        for idx, chunk in self._all_chunks():
            if idx % self.num_shards == self.shard_index:
                yield chunk

    @staticmethod
    def _chunk_rows(chunk: bytes) -> int:
        # one row per newline, plus a trailing unterminated line (the file
        # tail) — matching parse_criteo_tsv's segment semantics exactly
        return chunk.count(b"\n") + (0 if chunk.endswith(b"\n") else 1)

    def shard_batch_counts(self) -> list:
        """Full batches each shard will yield this epoch (``drop_remainder``
        semantics): one newline-counting pass over the file, cached by
        (path, size, mtime).  The same in every process by construction."""
        st = os.stat(self.path)
        key = (self.path, st.st_size, st.st_mtime_ns, self.chunk_bytes,
               self.num_shards)
        if self._count_cache is None or self._count_cache[0] != key:
            rows = [0] * self.num_shards
            for idx, chunk in self._all_chunks():
                rows[idx % self.num_shards] += self._chunk_rows(chunk)
            self._count_cache = (key, rows)
        return [r // self.batch_size for r in self._count_cache[1]]

    # -- epoch iterator ----------------------------------------------------

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        bs = self.batch_size
        # Several shards: each stops at the smallest shard's batch count, so
        # all processes take the same number of steps (chunk ownership is
        # uneven, and a process whose loader runs longer hangs the
        # collectives).
        limit = None
        if self.num_shards > 1 and self.sync_batches:
            limit = min(self.shard_batch_counts())
        emitted = 0
        carry: Optional[Dict[str, np.ndarray]] = None
        for raw in self._chunks():
            if limit is not None and emitted >= limit:
                return
            parsed = parse_criteo_tsv(raw, self.hash_sizes)
            cols = _columns(parsed, self.target_fields)
            n = len(cols[self.target_fields])
            if n == 0:
                continue
            if self.shuffle:
                order = rng.permutation(n)
                cols = {k: v[order] for k, v in cols.items()}
            if carry is not None:
                cols = {k: np.concatenate([carry[k], v]) for k, v in cols.items()}
                n = len(cols[self.target_fields])
                carry = None
            stop = n - (n % bs)
            for s in range(0, stop, bs):
                if limit is not None and emitted >= limit:
                    return
                yield {k: v[s:s + bs] for k, v in cols.items()}
                emitted += 1
            if stop < n:
                carry = {k: v[stop:] for k, v in cols.items()}
        if carry is not None and not self.drop_remainder and limit is None:
            yield carry


def open_criteo_stream(
    path: str,
    hash_sizes: Sequence[int],
    batch_size: int,
    *,
    chunk_bytes: int = 256 << 20,
    shuffle: bool = False,
    seed: int = 0,
    target_fields: str = "label",
    **kwargs,
) -> CriteoFileIterable:
    """Convenience constructor mirroring :class:`CriteoFileIterable`."""
    return CriteoFileIterable(
        path, hash_sizes, batch_size=batch_size, chunk_bytes=chunk_bytes,
        shuffle=shuffle, seed=seed, target_fields=target_fields, **kwargs,
    )


def file_larger_than(path: str, threshold_bytes: int) -> bool:
    """True when streaming should be preferred for ``path`` (size gate)."""
    try:
        return os.path.getsize(path) > threshold_bytes
    except OSError:
        return False


__all__ = ["CriteoFileIterable", "open_criteo_stream", "file_larger_than"]
