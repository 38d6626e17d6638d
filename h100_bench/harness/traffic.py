"""The samplers that traffic generators (``h100_bench/generators/``) share.

:func:`zipf` is numpy 2.0's Zipf sampler, copied here, so that a seed gives
the same bits on any numpy (numpy's own ``Generator.zipf`` draws otherwise
after 2.0).
"""

from __future__ import annotations

import numpy as np

_INT64_MAX = float(np.iinfo(np.int64).max)


def zipf(rng: np.random.Generator, a: float, size: int) -> np.ndarray:
    """``rng.zipf(a, size)`` as numpy 2.0 draws it, on any numpy version
    (a copy of the port's ``data/sample_data.py`` ``zipf``).

    numpy 2.0's ``random_zipf`` runs vectorized over ``rng``'s doubles: an
    attempt takes two, ``U = 1 - d0`` and ``V = d1``, and accepts ``X =
    floor(U ** (-1 / (a - 1)))`` when ``1 <= X <= INT64_MAX`` and ``V X (T -
    1) / (b - 1) <= T / b``, with ``T = (1 + 1 / X) ** (a - 1)`` and ``b = 2
    ** (a - 1)``.  ``rng`` ends where numpy 2.0's sampler leaves it."""
    am1 = a - 1.0
    b = 2.0 ** am1
    out = np.empty(size, np.int64)
    filled = 0
    while filled < size:
        need = size - filled
        start = rng.bit_generator.state
        attempts = need + need // 4 + 64
        d = rng.random(2 * attempts)
        u, v = 1.0 - d[0::2], d[1::2]
        with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
            x = np.floor(u ** (-1.0 / am1))
            t = (1.0 + 1.0 / x) ** am1
            accept = (x >= 1.0) & (x <= _INT64_MAX) & (v * x * (t - 1.0) / (b - 1.0) <= t / b)
        hits = np.flatnonzero(accept)[:need]
        out[filled:filled + len(hits)] = x[hits]
        filled += len(hits)
        if filled == size:  # give back the doubles past the last attempt
            rng.bit_generator.state = start
            if len(hits):
                rng.random(2 * (int(hits[-1]) + 1))
    return out


__all__ = ["zipf"]
