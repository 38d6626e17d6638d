"""Multi-hot CTR batches: the generator of the ``train_multihot`` mix.

MLPerf Training's DLRM-DCNv2 reads Criteo 1TB made multi-hot by
``materialize_synthetic_multihot_dataset.py``: in its ``uniform`` mode each
original one-hot id of a field gets one fixed bag of ``h_f`` ids, the
original first.  Here, per batch: each field's first ids from a Zipf law
clipped to the field (as the ``train`` mix draws them,
``generators/ctr_zipf.py``), each other id of the bag a fixed function of
(field, first id, slot), uniform over the field by a hash seeded with
``bag_seed`` (:func:`bag_ids`); then the dense values N(0, 1); then the
labels Bernoulli(``label_p``).  The keys of a mix:

* ``batch_size``: examples a step; ``pool_batches``: distinct batches,
  cycled through the window;
* ``zipf_a``: the Zipf exponent of every field's first ids;
* ``bag_seed``: the seed of the bags, a property of the dataset (the same
  first id has the same bag whatever ``--seed`` draws);
* ``label_p``: the labels' positive share; ``why``.

The configuration gives the fields: ``field_sizes``, ``hots`` and
``num_dense``.  Field ``i`` of a batch is ``cat_{i}``, ``(B, hots[i])``
int32.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np

from harness.traffic import zipf

KEYS = {"generator", "batch_size", "pool_batches", "zipf_a", "bag_seed", "label_p", "why"}
_M64 = (1 << 64) - 1


def check(mix: Dict, path: Path) -> None:
    missing, unknown = KEYS - set(mix), set(mix) - KEYS
    if missing or unknown:
        raise ValueError(f"{path}: traffic mix keys missing {sorted(missing)}, "
                         f"unknown {sorted(unknown)}")
    if not mix["zipf_a"] > 1.0:
        raise ValueError(f"{path}: zipf_a must exceed 1, got {mix['zipf_a']}")
    if not 0 <= mix["bag_seed"] <= _M64:
        raise ValueError(f"{path}: bag_seed must fit 64 unsigned bits")


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer on uint64 (wrapping arithmetic)."""
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def bag_ids(first: np.ndarray, field: int, hot: int, size: int, bag_seed: int) -> np.ndarray:
    """``(B, hot)`` int32 bags of the ``(B,)`` first ids of field ``field``
    of ``size`` ids: slot 0 the first id, slot ``k`` ``hash(bag_seed, field,
    first, k) mod size``."""
    out = np.empty((first.shape[0], hot), np.int32)
    out[:, 0] = first
    if hot > 1:
        with np.errstate(over="ignore"):
            key = (np.uint64(bag_seed) + np.uint64(field) * np.uint64(0x9E3779B97F4A7C15)
                   + first.astype(np.uint64)[:, None] * np.uint64(1 << 8)
                   + np.arange(1, hot, dtype=np.uint64)[None, :])
            out[:, 1:] = (_mix64(key) % np.uint64(size)).astype(np.int32)
    return out


def make_pool(mix: Dict, cfg: Dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """The pool of ``pool_batches`` host batches of ``mix`` from ``seed``:
    dicts of ``cat_{i}`` ``(B, hots[i])`` int32 ids, ``dense_{j}`` float32
    values and a float32 ``label``."""
    rng = np.random.default_rng(seed)
    batch = mix["batch_size"]
    pool = []
    for _ in range(mix["pool_batches"]):
        b = {}
        for i, (v, h) in enumerate(zip(cfg["field_sizes"], cfg["hots"])):
            first = np.minimum(zipf(rng, mix["zipf_a"], batch) - 1, v - 1).astype(np.int32)
            b[f"cat_{i}"] = bag_ids(first, i, h, v, mix["bag_seed"])
        for j in range(cfg["num_dense"]):
            b[f"dense_{j}"] = rng.normal(size=batch).astype(np.float32)
        b["label"] = (rng.uniform(size=batch) < mix["label_p"]).astype(np.float32)
        pool.append(b)
    return pool


__all__ = ["KEYS", "bag_ids", "check", "make_pool"]
