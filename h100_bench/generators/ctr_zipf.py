"""CTR batches with Zipf-distributed ids: the generator of the ``train`` and
``train_longtail`` mixes.

It makes a pool of host batches from the seed, as ``bench.py:59-71`` makes
its batches: per batch, each categorical field's ids from a Zipf law, then
the dense values N(0, 1), then the labels Bernoulli(``label_p``).  The keys
of a mix:

* ``batch_size``: examples a step; ``pool_batches``: distinct batches,
  cycled through the window;
* ``zipf_a``: the Zipf exponent of every field's ranks;
* ``ids``: how a rank enters a field of ``v`` ids: ``clip``,
  ``min(rank - 1, v - 1)``, bench.py's rule (the tail piles up on the
  field's last id), or ``hash``, ``((rank - 1) * hash_multiplier) mod v``,
  a bijection of the residues where the multiplier is prime to ``v``: a
  long tail spread over the whole field;
* ``label_p``: the labels' positive share; ``why``.

The configuration gives the fields: ``field_sizes`` and ``num_dense``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np

from harness.traffic import zipf

KEYS = {"generator", "batch_size", "pool_batches", "zipf_a", "ids", "hash_multiplier",
        "label_p", "why"}


def check(mix: Dict, path: Path) -> None:
    missing, unknown = KEYS - set(mix), set(mix) - KEYS
    if missing or unknown:
        raise ValueError(f"{path}: traffic mix keys missing {sorted(missing)}, "
                         f"unknown {sorted(unknown)}")
    if mix["ids"] not in ("clip", "hash"):
        raise ValueError(f"{path}: ids must be 'clip' or 'hash', got {mix['ids']!r}")
    if not mix["zipf_a"] > 1.0:
        raise ValueError(f"{path}: zipf_a must exceed 1, got {mix['zipf_a']}")
    if mix["hash_multiplier"] % 2 == 0:
        raise ValueError(f"{path}: hash_multiplier must be odd")


def field_ids(ranks: np.ndarray, size: int, mix: Dict) -> np.ndarray:
    """Ranks (from 1) into ids of a field of ``size`` ids, by the mix's rule."""
    if mix["ids"] == "clip":
        return np.minimum(ranks - 1, size - 1).astype(np.int32)
    # (r - 1) mod v < 2^24 and mult mod v < 2^24: the product fits int64
    mult = mix["hash_multiplier"] % size
    return (((ranks - 1) % size) * mult % size).astype(np.int32)


def make_pool(mix: Dict, cfg: Dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """The pool of ``pool_batches`` host batches of ``mix`` from ``seed``:
    dicts of ``cat_{i}`` int32 ids, ``dense_{j}`` float32 values and a
    float32 ``label``, as the program's CTR pipelines read them."""
    rng = np.random.default_rng(seed)
    batch = mix["batch_size"]
    pool = []
    for _ in range(mix["pool_batches"]):
        b = {}
        for i, v in enumerate(cfg["field_sizes"]):
            b[f"cat_{i}"] = field_ids(zipf(rng, mix["zipf_a"], batch), v, mix)
        for j in range(cfg["num_dense"]):
            b[f"dense_{j}"] = rng.normal(size=batch).astype(np.float32)
        b["label"] = (rng.uniform(size=batch) < mix["label_p"]).astype(np.float32)
        pool.append(b)
    return pool


__all__ = ["KEYS", "check", "field_ids", "make_pool"]
