"""The port's Criteo DAC parser (``torecsys_tpu_torch/data/native``): its
C++ route and its Python route each equal the JAX package's
``parse_criteo_tsv`` (the JAX package's C++ route on this rig, which has
g++) bit for bit, on the bundled sample read in place and on mangled inputs
(garbage dense tokens, malformed rows, extra fields, empty tokens, a missing
trailing newline, ``max_rows``, empty input); the checks on ``hash_sizes``;
the Python fallback where no compiler builds the library.  Mirrors
``tests/test_native.py``."""

import logging
import os

import numpy as np
import pytest

from torecsys_tpu.data import native as jax_native
from torecsys_tpu_torch.data import native

SAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "torecsys_tpu", "data", "sample", "criteo_sample.tsv")
HASH_SIZES = [1000 + 37 * f for f in range(native.NUM_CATS)]
GARBAGE_DENSE = ["12a", "+5", "-3", " 7", "+", "-", "0x1f", "3.5", "1e3", ""]


def _synthetic_lines(n, seed=0, mangle=False):
    """tests/test_native.py's generator."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        label = str(int(rng.uniform() < 0.3))
        dense = ["" if rng.uniform() < 0.2 else str(int(rng.integers(-2, 1000)))
                 for _ in range(native.NUM_DENSE)]
        cats = ["" if rng.uniform() < 0.2 else f"{int(rng.integers(0, 2**32)):08x}"
                for _ in range(native.NUM_CATS)]
        if mangle and i % 11 == 5:
            for f in range(native.NUM_DENSE):
                dense[f] = GARBAGE_DENSE[(i + f) % len(GARBAGE_DENSE)]
        line = "\t".join([label] + dense + cats)
        if mangle and i % 7 == 3:
            line = line[: len(line) // 2]
        if mangle and i % 13 == 8:
            line = line + "\textra\tfields"
        lines.append(line)
    return ("\n".join(lines) + "\n").encode()


def _sample():
    with open(SAMPLE, "rb") as f:
        return f.read()


CASES = {
    "sample": lambda: (_sample(), {}),
    "sample_max_rows": lambda: (_sample(), {"max_rows": 777}),
    "clean": lambda: (_synthetic_lines(200, seed=3), {}),
    "clean_no_trailing_newline": lambda: (_synthetic_lines(200, seed=3)[:-1], {}),
    "mangled": lambda: (_synthetic_lines(200, seed=3, mangle=True), {}),
    "mangled_no_trailing_newline": lambda: (_synthetic_lines(200, seed=3, mangle=True)[:-1], {}),
    "max_rows": lambda: (_synthetic_lines(20, seed=5), {"max_rows": 7}),
    "max_rows_past_the_end": lambda: (_synthetic_lines(20, seed=5), {"max_rows": 50}),
    "crlf": lambda: (_synthetic_lines(30, seed=6).replace(b"\n", b"\r\n"), {}),
    "empty": lambda: (b"", {}),
}


def _same_bits(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(np.ascontiguousarray(a).view(np.uint8),
                               np.ascontiguousarray(b).view(np.uint8)))


@pytest.mark.parametrize("route", ["c++", "python"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_each_route_equals_the_jax_parser_bit_for_bit(case, route):
    assert jax_native.native_available() and native.native_available(), "this rig has g++"
    data, kw = CASES[case]()
    want = jax_native.parse_criteo_tsv(data, HASH_SIZES, num_threads=4, **kw)
    got = native.parse_criteo_tsv(data, HASH_SIZES, num_threads=4,
                                  force_python=route == "python", **kw)
    assert set(got) == set(want) == {"label", "dense", "cats"}
    for k in want:
        assert _same_bits(got[k], want[k]), k
    if case == "sample":
        assert got["label"].shape == (4096,)


def test_threads_do_not_change_the_bits():
    data = _synthetic_lines(300, seed=9, mangle=True)
    one = native.parse_criteo_tsv(data, HASH_SIZES, num_threads=1)
    for threads in (2, 7, 64):
        many = native.parse_criteo_tsv(data, HASH_SIZES, num_threads=threads)
        assert all(_same_bits(one[k], many[k]) for k in one)


@pytest.mark.parametrize("sizes,match", [([100] * 25, "26 entries"),
                                         ([100] * 25 + [0], "positive"),
                                         ([100] * 25 + [-3], "positive")])
@pytest.mark.parametrize("force_python", [False, True])
def test_hash_sizes_are_checked(sizes, match, force_python):
    with pytest.raises(ValueError, match=match):
        native.parse_criteo_tsv(b"1\t2\n", sizes, force_python=force_python)


def test_route_and_library_name():
    assert native.native_available()
    path = native.parser_library_path()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libcriteo_parser_")
    assert path.exists()


def test_without_a_compiler_the_parser_falls_back_to_python(monkeypatch, tmp_path, caplog):
    def no_compiler(*args, **kwargs):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native, "_parser", None)
    monkeypatch.setattr(native, "_parser_failed", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.subprocess, "run", no_compiler)
    data = _synthetic_lines(40, seed=2, mangle=True)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert not native.native_available()
        got = native.parse_criteo_tsv(data, HASH_SIZES)
    assert "parsing in Python" in caplog.text
    want = jax_native.parse_criteo_tsv(data, HASH_SIZES)
    assert all(_same_bits(got[k], want[k]) for k in want)
