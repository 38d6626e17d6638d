"""Sample datasets: downloads, delimited-file loaders, and a synthetic CTR
generator (counterpart of ``torecsys_tpu/data/sample_data.py``).

* ``request_download`` and the ``download_*`` functions fetch MovieLens,
  Criteo DAC, Book-Crossing and Jester archives over HTTP
  (``urllib.request``) and unzip them;
* ``load_ml_data``, ``load_criteo_data`` and ``load_bx_data`` read the
  files into ``{column: np.ndarray}`` dicts, with each column's type
  inferred as a CSV reader infers it (:func:`read_table`): integers with no
  missing value → int64, numbers → float64 with NaN for a missing one,
  anything else → an object array of str with NaN for a missing one;
* ``load_criteo_batches`` parses a Criteo DAC TSV through the C++ parser
  into hashed, fixed-shape arrays;
* :func:`make_synthetic_ctr` is a deterministic synthetic CTR dataset with
  planted feature interactions, so that tests and benchmarks run with no
  network access.
"""

from __future__ import annotations

import csv
import logging
import math
import os
import re
import zipfile
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

ML_URLS = {
    "20m": "https://files.grouplens.org/datasets/movielens/ml-20m.zip",
    "latest-small": "https://files.grouplens.org/datasets/movielens/ml-latest-small.zip",
    "latest": "https://files.grouplens.org/datasets/movielens/ml-latest.zip",
    "100k": "https://files.grouplens.org/datasets/movielens/ml-100k.zip",
    "1m": "https://files.grouplens.org/datasets/movielens/ml-1m.zip",
    "10m": "https://files.grouplens.org/datasets/movielens/ml-10m.zip",
}
CRITEO_URL = ("https://go.criteo.net/"
              "criteo-research-kaggle-display-advertising-challenge-dataset.tar.gz")
BX_URL = "http://www2.informatik.uni-freiburg.de/~cziegler/BX/BX-CSV-Dump.zip"
JESTER_URLS = [
    "https://goldberg.berkeley.edu/jester-data/jester-data-1.zip",
    "https://goldberg.berkeley.edu/jester-data/jester-data-2.zip",
    "https://goldberg.berkeley.edu/jester-data/jester-data-3.zip",
]

CRITEO_COLUMNS = (
    ["label"]
    + [f"I{i}" for i in range(1, 14)]
    + [f"C{i}" for i in range(1, 27)]
)
ML_COLUMNS = ["user_id", "item_id", "rating", "timestamp"]

Columns = Dict[str, np.ndarray]


def request_download(url: str, dest_dir: str, unzip: bool = True) -> str:
    """Download ``url`` into ``dest_dir`` (and unzip a .zip archive).

    Needs network access; raises RuntimeError when the fetch fails, so that
    offline use falls back to :func:`make_synthetic_ctr`.
    """
    import urllib.request

    os.makedirs(dest_dir, exist_ok=True)
    fname = os.path.join(dest_dir, url.rsplit("/", 1)[-1])
    if not os.path.exists(fname):
        logger.info("downloading %s -> %s", url, fname)
        tmp = fname + ".part"
        try:
            with urllib.request.urlopen(url, timeout=60) as r, open(tmp, "wb") as f:
                while True:
                    chunk = r.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
            os.replace(tmp, fname)
        except OSError as e:
            raise RuntimeError(f"download of {url} failed: {e}") from e
    if unzip and fname.endswith(".zip"):
        with zipfile.ZipFile(fname) as z:
            z.extractall(dest_dir)
    return fname


def download_ml_data(size: str = "100k", directory: str = "./data") -> str:
    """MovieLens download."""
    if size not in ML_URLS:
        raise ValueError(f"unknown MovieLens size {size!r}; choose from {sorted(ML_URLS)}")
    return request_download(ML_URLS[size], directory)


def download_criteo_data(directory: str = "./data") -> str:
    """Criteo DAC download."""
    return request_download(CRITEO_URL, directory, unzip=False)


def download_bx_data(directory: str = "./data") -> str:
    """Book-Crossing download."""
    return request_download(BX_URL, directory)


def download_jester_data(directory: str = "./data") -> list:
    """Jester download."""
    return [request_download(u, directory) for u in JESTER_URLS]


# ---- delimited files → column dicts -----------------------------------------

_INT = re.compile(r"^\s*[+-]?\d+\s*$")


def _is_float(v: str) -> bool:
    try:
        float(v)
    except ValueError:
        return False
    return "_" not in v


def infer_column(values: Sequence[str]) -> np.ndarray:
    """One column of raw strings → a typed array: int64 when every value is
    an integer and none is missing, float64 when every present value is a
    number (NaN for a missing one; an all-missing column too), bool for
    ``True``/``False`` with none missing, else an object array of str with
    NaN for a missing one.  An empty string is missing."""
    present = [v for v in values if v != ""]
    missing = len(present) != len(values)
    if not present:
        return np.full(len(values), np.nan)
    if not missing and all(_INT.match(v) for v in present):
        return np.asarray([int(v) for v in values], dtype=np.int64)
    if all(_INT.match(v) or _is_float(v) for v in present):
        return np.asarray([float(v) if v != "" else math.nan for v in values],
                          dtype=np.float64)
    if not missing and set(present) <= {"True", "False"}:
        return np.asarray([v == "True" for v in values], dtype=bool)
    out = np.empty(len(values), dtype=object)
    out[:] = [v if v != "" else math.nan for v in values]
    return out


def _rows(path: str, sep: str, encoding: str) -> Iterable[List[str]]:
    with open(path, newline="", encoding=encoding) as f:
        if len(sep) == 1:
            yield from csv.reader(f, delimiter=sep)
        else:
            for line in f:
                yield line.rstrip("\r\n").split(sep)


def read_table(path: str, sep: str = ",", names: Optional[Sequence[str]] = None,
               nrows: Optional[int] = None, encoding: str = "utf-8") -> Columns:
    """A delimited text file → ``{column: np.ndarray}`` in file order.

    The first row names the columns unless ``names`` is given; ``nrows``
    caps the data rows; a one-character ``sep`` reads through ``csv`` (so
    quoted fields work), a longer one splits each line on it.  Short rows
    are padded with missing values.  Column types as
    :func:`infer_column`.
    """
    rows = _rows(path, sep, encoding)
    header = list(names) if names is not None else next(rows, [])
    cells: List[List[str]] = [[] for _ in header]
    for i, row in enumerate(rows):
        if nrows is not None and i >= nrows:
            break
        if not row:
            continue
        if len(row) > len(header):
            raise ValueError(f"{path}: data row {i} has {len(row)} fields, expected "
                             f"{len(header)}")
        for j, col in enumerate(cells):
            col.append(row[j] if j < len(row) else "")
    return {name: infer_column(col) for name, col in zip(header, cells)}


def load_ml_data(directory: str, size: str = "100k") -> Columns:
    """MovieLens ratings → ``{column: array}``."""
    if size == "100k":
        return read_table(os.path.join(directory, "ml-100k", "u.data"), sep="\t",
                          names=ML_COLUMNS)
    if size == "1m":
        return read_table(os.path.join(directory, "ml-1m", "ratings.dat"), sep="::",
                          names=ML_COLUMNS)
    return read_table(os.path.join(directory, f"ml-{size}", "ratings.csv"))


def load_criteo_data(path: str, nrows: Optional[int] = None) -> Columns:
    """Criteo DAC 39-column TSV → ``{column: array}``, the raw columns
    (``label``, ``I1..I13``, ``C1..C26``) with no hashing or transform."""
    return read_table(path, sep="\t", names=CRITEO_COLUMNS, nrows=nrows)


def load_criteo_batches(path: str, hash_sizes: Optional[Tuple[int, ...]] = None,
                        nrows: Optional[int] = None, num_threads: int = 0) -> Columns:
    """Criteo DAC TSV → fixed-shape hashed arrays through the C++ parser
    (``data.native``): the 26 categorical fields FNV-1a hashed modulo
    ``hash_sizes`` (default 100,000 each), the 13 dense fields log1p'd.

    Returns ``{"label": (R,) f32, "dense": (R, 13) f32, "cats": (R, 26) i32}``.
    """
    from torecsys_tpu_torch.data.native import NUM_CATS, parse_criteo_tsv

    if hash_sizes is None:
        hash_sizes = (100_000,) * NUM_CATS
    with open(path, "rb") as f:
        data = f.read()
    return parse_criteo_tsv(data, hash_sizes, max_rows=nrows, num_threads=num_threads)


def load_bx_data(directory: str) -> Columns:
    """Book-Crossing ratings → ``{column: array}``."""
    return read_table(os.path.join(directory, "BX-Book-Ratings.csv"), sep=";",
                      encoding="latin-1")


_INT64_MAX = float(np.iinfo(np.int64).max)


def zipf(rng: np.random.Generator, a: float, size: int) -> np.ndarray:
    """``rng.zipf(a, size)`` as numpy 2.0 draws it, on any numpy version.

    numpy's rejection sampler changed after 2.0 (2.3 accepts otherwise and
    so consumes another number of draws), which made this module's data,
    and every draw after it, depend on the installed numpy.  Here numpy
    2.0's ``random_zipf`` runs vectorized over ``rng``'s doubles: an attempt
    takes two, ``U = 1 - d0`` and ``V = d1``, and accepts ``X = floor(U **
    (-1 / (a - 1)))`` when ``1 <= X <= INT64_MAX`` and ``V X (T - 1) / (b -
    1) <= T / b``, with ``T = (1 + 1 / X) ** (a - 1)`` and ``b = 2 ** (a -
    1)``.  ``rng`` ends where numpy 2.0's sampler leaves it."""
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
            rng.random(2 * (int(hits[-1]) + 1)) if len(hits) else None
    return out


def make_synthetic_ctr(
    num_rows: int = 100_000,
    field_sizes: Tuple[int, ...] = (1000, 500, 200, 100, 50, 20),
    num_dense: int = 4,
    seed: int = 0,
    noise: float = 0.25,
    pair_scale: float = 1.0,
) -> Dict[str, np.ndarray]:
    """Deterministic synthetic CTR data with planted pairwise interactions
    (the same arrays as the JAX package's for the same arguments).

    Each categorical field gets a latent 8-dim factor table; the true logit is
    a linear term + FM-style pairwise factor interactions + dense effects +
    Gaussian noise, so FM-family models can beat logistic regression on
    held-out AUC.  ``pair_scale`` > 1 raises the interactions' share of the
    label variance.

    Returns dict with ``cat_{i}`` int32 columns, ``dense_{j}`` float32
    columns, and float32 ``label``.
    """
    rng = np.random.default_rng(seed)
    k = 8
    cats, contrib = [], np.zeros(num_rows)
    factors = [rng.normal(0, 0.3, size=(v, k)) for v in field_sizes]
    weights = [rng.normal(0, 0.5, size=(v,)) for v in field_sizes]
    for v, f, w in zip(field_sizes, factors, weights):
        # Zipf-like id distribution, the usual CTR regime
        raw = zipf(rng, 1.3, num_rows)
        ids = np.minimum(raw - 1, v - 1).astype(np.int32)
        cats.append(ids)
        contrib += w[ids]
    # FM pairwise: sum over i<j of <f_i[id_i], f_j[id_j]>
    latent = np.stack([f[ids] for f, ids in zip(factors, cats)], axis=1)  # (R, N, k)
    s = latent.sum(axis=1)
    pair = 0.5 * ((s**2).sum(-1) - (latent**2).sum(axis=(1, 2)))
    contrib += pair_scale * pair

    dense = rng.normal(size=(num_rows, num_dense)).astype(np.float32)
    dense_w = rng.normal(0, 0.4, size=(num_dense,))
    contrib += dense @ dense_w

    logit = (contrib - contrib.mean()) / (contrib.std() + 1e-9)
    p = 1.0 / (1.0 + np.exp(-(logit + noise * rng.normal(size=num_rows))))
    label = (rng.uniform(size=num_rows) < p).astype(np.float32)

    out: Dict[str, np.ndarray] = {"label": label}
    for i, ids in enumerate(cats):
        out[f"cat_{i}"] = ids
    for j in range(num_dense):
        out[f"dense_{j}"] = dense[:, j].astype(np.float32)
    return out


__all__ = ["CRITEO_COLUMNS", "download_bx_data", "download_criteo_data", "download_jester_data",
           "download_ml_data", "infer_column", "load_bx_data", "load_criteo_batches",
           "load_criteo_data", "load_ml_data", "make_synthetic_ctr", "read_table",
           "request_download"]
