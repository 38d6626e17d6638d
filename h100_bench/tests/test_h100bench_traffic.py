"""The traffic generator: the same bits from one seed, numpy 2.0's Zipf
sampler, and each mix's ids inside its fields."""

from __future__ import annotations

import numpy as np
import pytest
from conftest import BENCH_DIR, TINY_FIELDS

from harness import traffic
from harness.cell import load_mix

MIXES = ("train", "train_longtail")
CFG = {"field_sizes": TINY_FIELDS, "num_dense": 3}


def load(name):
    return load_mix(BENCH_DIR / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", MIXES)
def test_a_seed_gives_the_same_bits_twice(name):
    mix, gen = load(name)
    mix = dict(mix, batch_size=256, pool_batches=3)
    a = gen.make_pool(mix, CFG, 2**31 + 17)
    b = gen.make_pool(mix, CFG, 2**31 + 17)
    c = gen.make_pool(mix, CFG, 2**31 + 18)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        assert all(x[k].tobytes() == y[k].tobytes() and x[k].dtype == y[k].dtype for k in x)
    assert any(a[0][k].tobytes() != c[0][k].tobytes() for k in a[0])
    for batch in a:
        for i, v in enumerate(TINY_FIELDS):
            ids = batch[f"cat_{i}"]
            assert ids.dtype == np.int32 and ids.min() >= 0 and ids.max() < v


@pytest.mark.skipif(not np.__version__.startswith("2.0."), reason="numpy 2.0's own sampler")
@pytest.mark.parametrize("a", [1.05, 1.2, 1.3])
def test_zipf_is_numpy_2_0s_sampler(a):
    """The same draws as numpy 2.0's sampler, up to the last bits of a
    rank in the billions and over, which follow the power function's last
    bit (numpy's vectorized one here, the C library's there)."""
    ours, theirs = np.random.default_rng(5), np.random.default_rng(5)
    x, y = traffic.zipf(ours, a, 5000), theirs.zipf(a, 5000)
    exact = y < 2**32
    assert np.array_equal(x[exact], y[exact])
    assert np.all(np.abs(x[~exact] - y[~exact]) <= 1 + 4e-16 * y[~exact])
    assert ours.random() == theirs.random()  # both generators end at one place


def test_hash_is_a_bijection_of_each_fields_residues():
    mix, gen = load("train_longtail")
    for v in (3, 4, 10, 100, 1460, 20_000, 3_000_000):
        ranks = np.arange(1, v + 1, dtype=np.int64)
        assert np.unique(gen.field_ids(ranks, v, mix)).size == v


def test_clip_piles_the_tail_on_the_last_id():
    mix, gen = load("train")
    ids = gen.field_ids(np.array([1, 2, 100, 10**12]), 100, mix)
    assert ids.tolist() == [0, 1, 99, 99]


def test_a_mix_names_its_generator_and_keeps_to_its_keys(tmp_path):
    mix, _ = load("train")
    path = tmp_path / "mix.json"
    path.write_text(__import__("json").dumps(dict(mix, burst=3)))
    with pytest.raises(ValueError, match="unknown"):
        load_mix(path)
    path.write_text(__import__("json").dumps({k: v for k, v in mix.items() if k != "generator"}))
    with pytest.raises(ValueError, match="generator"):
        load_mix(path)
