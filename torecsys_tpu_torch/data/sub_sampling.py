"""Word2vec-style frequency sub-sampling of rows (counterpart of
``torecsys_tpu/data/sub_sampling.py``): drop rows of over-frequent keys with
the word2vec discard probability, by the paper's formula
``P_keep = sqrt(t / f)`` or word2vec.c's ``P_keep = (sqrt(f/t) + 1) · (t/f)``.
"""

from __future__ import annotations

from typing import Union

import numpy as np


def sub_sampling(
    data,
    key: Union[int, str],
    formula: str = "code",
    threshold: float = 1e-5,
    seed: int = 0,
):
    """Subsample rows of an ndarray / DataFrame by key-column frequency.

    Args:
        data: 2-D ``np.ndarray`` (key = column index) or a data frame
            (anything with ``.iloc``; key = column name).
        key: the column whose value frequencies drive the discard.
        formula: ``'paper'`` (``sqrt(t/f)``) or ``'code'``
            (``(sqrt(f/t)+1)·t/f``, word2vec.c).
        threshold: the sub-sampling threshold t.
        seed: PRNG seed.

    Returns:
        Same container type with sampled rows.
    """
    rng = np.random.default_rng(seed)
    is_frame = hasattr(data, "iloc")
    col = (data[key] if is_frame else data[:, key])
    col = np.asarray(col)

    uniques, counts = np.unique(col, return_counts=True)
    freq = counts.astype(np.float64) / col.shape[0]
    if formula == "paper":
        p_keep = np.sqrt(threshold / freq)
    elif formula == "code":
        p_keep = (np.sqrt(freq / threshold) + 1.0) * (threshold / freq)
    else:
        raise ValueError(f"unknown formula {formula!r}; use 'paper' or 'code'")
    p_keep = np.clip(p_keep, 0.0, 1.0)
    keep_prob = dict(zip(uniques.tolist(), p_keep.tolist()))

    mask = rng.uniform(size=col.shape[0]) < np.vectorize(keep_prob.get)(col)
    if is_frame:
        return data[mask]
    return data[mask, :]
