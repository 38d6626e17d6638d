"""Negative-sampling miners (counterpart of ``torecsys_tpu/miners``).

A miner is called as the JAX package's is, ``miner(key, batch,
target_field) → (pos_batch, neg_batch)``, inside the train step.  Its key
is not a JAX PRNG key but an integer: a Python int or a 0-d int64 tensor
below 2^32, made with :func:`fold_in` from the Trainer's seed, the state's
step counter (a device tensor) and a stream constant.  The draws are a
counter-based hash of ``(key, position)`` in int64 tensor arithmetic
(:func:`randint`), the same integers on the CPU and on the card, and a
function of the key alone: a step captured in a CUDA graph draws in each
replay what the eager step draws, and no ``torch.Generator`` is involved.

The hash is Wellons' ``lowbias32`` over uint32 values held in int64: every
intermediate stays in ``[0, 2^49)``, so shifts are logical and nothing
overflows (torch has no unsigned 64-bit arithmetic, and ``>>`` on a
negative int64 is arithmetic).  The same functions take Python ints.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

Key = Union[int, torch.Tensor]

_MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x: Key, c: int) -> Key:
    """``(x * c) mod 2^32`` for ``0 <= x < 2^32``, in two 16-bit halves of
    ``c`` so that no product reaches 2^63."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def mix32(x: Key) -> Key:
    """``lowbias32``: a bijection of ``[0, 2^32)``."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def fold_in(key: Key, data: Key) -> Key:
    """A new key from ``key`` and ``data`` (ints or int tensors; only the
    low 32 bits of ``data`` count), a bijection of ``data`` for a fixed
    key."""
    return mix32((key + _mul32(data & _MASK32, _GOLDEN) + 0x7F4A7C15) & _MASK32)


def seed_key(seed: int) -> int:
    """The root key of ``seed``."""
    return mix32(seed & _MASK32)


def randint(key: Key, n: int, high: int, device=None, start: int = 0) -> torch.Tensor:
    """``n`` int64 draws uniform in ``[0, high)``: ``fold_in(key, i) % high``
    for positions ``start <= i < start + n`` (a bias of under ``high /
    2^32``), on ``key``'s device, or ``device`` for an int key."""
    if isinstance(key, torch.Tensor):
        device = key.device
    positions = torch.arange(start, start + n, dtype=torch.int64, device=device)
    return fold_in(key, positions) % high


class BaseMiner:
    """``miner(key, batch, target_field) → (pos_batch, neg_batch)``.  Under
    a split data axis the train and ranking evaluation steps call it as
    ``miner(key, batch, target_field, pool=..., part=(d, dp))``: ``batch`` is
    the rank's slice ``d`` of ``dp`` equal slices of the global batch, and
    ``pool`` the global batch's target field, which the JAX package's miner
    draws from."""


@dataclasses.dataclass(frozen=True)
class UniformBatchMiner(BaseMiner):
    """In-batch uniform negative sampling: each anchor row is paired with
    ``num_negs`` targets of the batch's rows, drawn uniformly with
    replacement.  The positive batch is the batch itself; the negative
    batch ``(B·num_negs, ...)`` repeats every other field ``num_negs``
    times a row (``jnp.repeat``'s order: row i's copies are rows
    ``i·num_negs`` to ``i·num_negs + num_negs - 1``) and takes the target
    from the drawn rows.  The copies are views expanded and reshaped, and
    the draws device ops: nothing reads a device value back to the host.

    Of a slice of the batch (``part = (d, dp)``: the ``d``-th of ``dp`` equal
    slices, ``pool`` the whole batch's targets) it takes the whole batch's
    draws of the slice's anchors, from the whole batch's targets: the draws
    of one call over the whole batch, cut to the slice."""

    num_negs: int = 1

    def draw(self, key: Key, batch_size: int, device=None, part=(0, 1)) -> torch.Tensor:
        """The ``(B·num_negs,)`` rows the negatives' targets come from; of
        slice ``d`` of ``dp`` (``part``), its run of the whole batch's
        ``dp·B·num_negs`` draws over its ``dp·B`` rows."""
        d, dp = part
        n = batch_size * self.num_negs
        return randint(key, n, batch_size * dp, device, start=d * n)

    def __call__(self, key: Key, batch: Dict[str, torch.Tensor], target_field: str,
                 pool: Optional[torch.Tensor] = None,
                 part=(0, 1)) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        target = batch[target_field]
        b, k = target.shape[0], self.num_negs
        neg_idx = self.draw(key, b, target.device, part)
        neg_batch = {}
        for name, x in batch.items():
            if name == target_field:
                neg_batch[name] = (x if pool is None else pool).index_select(0, neg_idx)
            else:
                tail = x.shape[1:]
                neg_batch[name] = x.unsqueeze(1).expand(b, k, *tail).reshape(b * k, *tail)
        return dict(batch), neg_batch


MINERS = {"UniformBatchMiner": UniformBatchMiner}


def get_miner(name_or_miner, **kwargs):
    """Resolve a miner by registry name or pass an instance through."""
    if isinstance(name_or_miner, BaseMiner):
        return name_or_miner
    if name_or_miner not in MINERS:
        raise KeyError(f"unknown miner {name_or_miner!r}; available: {sorted(MINERS)}")
    return MINERS[name_or_miner](**kwargs)


__all__ = ["BaseMiner", "MINERS", "UniformBatchMiner", "fold_in", "get_miner", "mix32",
           "randint", "seed_key"]
