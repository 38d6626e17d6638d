"""Generate a Criteo-DAC-format sample shard (counterpart of
``torecsys_tpu/data/make_criteo_sample.py``; the same bytes for the same
``rows`` and ``seed``).

The shard is synthetic; it is the format that is under test: 39
tab-separated columns per line (label, 13 decimal ints with missing values,
26 hex tokens with missing values), what the Criteo parser
(``native/criteo_parser.cc``) reads.  The labels carry a planted signal (a
few "hot" categorical tokens and one dense feature shift the log-odds), so
a test can assert that parser → loader → Trainer learns (held-out AUC >
0.6), not only that it runs.

Run: ``python -m torecsys_tpu_torch.data.make_criteo_sample [rows] [path]``.
"""

from __future__ import annotations

import os

import numpy as np

DEFAULT_ROWS = 4096
DEFAULT_PATH = os.path.join(os.path.dirname(__file__), "sample", "criteo_sample.tsv")


def generate(rows: int = DEFAULT_ROWS, path: str = DEFAULT_PATH, seed: int = 7) -> str:
    rng = np.random.default_rng(seed)
    # per-categorical-field vocab sizes, long-tailed like the real DAC
    cat_vocab = [1400, 500, 300, 120, 60, 30, 900, 200, 80, 40,
                 700, 350, 150, 75, 35, 25, 500, 250, 100, 50,
                 400, 180, 90, 45, 20, 10]
    # planted signal: per field, token id 0..2 shift the logit
    cat_weights = [rng.normal(0.0, 1.6, size=3) for _ in cat_vocab]

    lines = []
    for _ in range(rows):
        logit = 0.0
        dense_vals = []
        for j in range(13):
            if rng.uniform() < 0.12:  # missing
                dense_vals.append("")
            else:
                v = int(rng.zipf(1.6) - 1)
                if j == 0:
                    logit += 0.6 * np.log1p(v)
                dense_vals.append(str(v))
        cat_vals = []
        for f, (v, w) in enumerate(zip(cat_vocab, cat_weights)):
            if rng.uniform() < 0.08:  # missing
                cat_vals.append("")
                continue
            tok = min(int(rng.zipf(1.3) - 1), v - 1)
            if tok < 3:
                logit += w[tok]
            # real DAC tokens are 8-hex-digit strings
            cat_vals.append(f"{(tok * 2654435761 + f) & 0xFFFFFFFF:08x}")
        p = 1.0 / (1.0 + np.exp(-(logit - 0.4)))
        label = "1" if rng.uniform() < p else "0"
        lines.append("\t".join([label] + dense_vals + cat_vals))

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


if __name__ == "__main__":
    import sys

    rows = int(sys.argv[1]) if len(sys.argv) > 1 else DEFAULT_ROWS
    path = sys.argv[2] if len(sys.argv) > 2 else DEFAULT_PATH
    out = generate(rows, path)
    print(out)
