"""The benchmark's tests: CPU tests of the harness at tiny sizes, and tests
marked ``h100`` that need the card and skip without one.

Run them from the checkout's root: ``python -m pytest h100_bench/tests -q``.
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for path in (str(ROOT), str(BENCH_DIR)):
    if path not in sys.path:
        sys.path.insert(0, path)

TINY_FIELDS = [4000, 2000, 1000, 600, 200, 100, 50, 50]


def pytest_configure(config):
    config.addinivalue_line("markers", "h100: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def tiny(cell_name: str, **mix):
    """The cell of ``BENCHMARK.json`` at a size the CPU runs in a second: 8
    fields of 8,000 rows, 3 dense values, towers of 16, CINs of 8 maps,
    batch 64, 2 steps a dispatch; the sparse on-device route, which the
    configuration's automatic choice takes on the card."""
    from harness import cell as cells

    c = cells.load(cell_name, ROOT)
    cfg = copy.deepcopy(c.config)
    cfg.update(field_sizes=TINY_FIELDS, num_dense=3, sparse_embeddings=True, presort=False,
               steps_per_execution=2, deep_layer_sizes=[16] * len(cfg["deep_layer_sizes"]))
    if "cin_layer_sizes" in cfg:
        cfg["cin_layer_sizes"] = [8] * len(cfg["cin_layer_sizes"])
    c.config = cfg
    c.mix = dict(c.mix, batch_size=64, pool_batches=8, **mix)
    return c


CELLS = ("deepfm_criteo.train", "xdeepfm_criteo.train", "deepfm_criteo.train_longtail")
