"""The port's data utilities against the JAX package's on the same inputs:
``make_synthetic_ctr``, the sample generator ``generate`` (the same bytes),
``IndexField``, ``SentenceField``, ``CollateFunction``, ``DataLoader`` over
both datasets, ``sub_sampling``, and the file loaders (the port reads with
``csv`` and numpy what the JAX package reads with pandas)."""

import os
import sys

import numpy as np
import pandas as pd
import pytest

import torecsys_tpu.data as jax_data
import torecsys_tpu_torch.data as data
from torecsys_tpu.data import make_criteo_sample as jax_sample
from torecsys_tpu.data import sample_data as jax_sd
from torecsys_tpu_torch.data import make_criteo_sample, sample_data

SAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "torecsys_tpu", "data", "sample", "criteo_sample.tsv")


def _assert_same(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        if want.dtype == object:
            assert all(a == b or (a != a and b != b) for a, b in zip(got.ravel(), want.ravel()))
        else:
            assert np.array_equal(got, want, equal_nan=want.dtype.kind == "f")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    else:
        assert got == want


def test_the_port_exports_every_name_of_the_jax_data_package():
    assert set(jax_data.__all__) <= set(data.__all__)


@pytest.mark.parametrize("kw", [{}, dict(num_rows=3000, field_sizes=(50, 7, 300), num_dense=2,
                                         seed=4, noise=0.5, pair_scale=3.0)])
def test_make_synthetic_ctr_gives_the_same_arrays(kw):
    kw = {"num_rows": 5000, **kw}
    _assert_same(data.make_synthetic_ctr(**kw), jax_data.make_synthetic_ctr(**kw))


def _zipf_numpy_2_0(rng, a, size):
    """numpy 2.0's ``random_zipf`` (``distributions.c``), a draw at a time."""
    import math

    am1, out = a - 1.0, []
    b = 2.0 ** am1
    while len(out) < size:
        u = 1.0 - rng.random()
        v = rng.random()
        x = math.floor(u ** (-1.0 / am1)) if u ** (-1.0 / am1) < math.inf else math.inf
        if x > np.iinfo(np.int64).max or x < 1.0:
            continue
        t = (1.0 + 1.0 / x) ** am1
        if v * x * (t - 1.0) / (b - 1.0) <= t / b:
            out.append(int(x))
    return np.array(out, np.int64)


@pytest.mark.parametrize("size,seed", [(1, 0), (20_000, 3), (20_001, 8)])
def test_zipf_is_numpy_2_0s_sampler_and_leaves_the_generator_as_it_does(size, seed):
    got_rng, want_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    np.testing.assert_array_equal(sample_data.zipf(got_rng, 1.3, size),
                                  _zipf_numpy_2_0(want_rng, 1.3, size))
    assert got_rng.bit_generator.state == want_rng.bit_generator.state


def test_make_synthetic_ctr_does_not_take_numpys_zipf(monkeypatch):
    """numpy's own sampler changed after 2.0, and the data with it: on a
    numpy 2.3 machine the parity protocol trained on other rows than the
    JAX package's column was measured on."""
    real = np.random.default_rng

    class NoZipf(np.random.Generator):
        def zipf(self, *args, **kwargs):
            raise AssertionError("Generator.zipf depends on the numpy version")

    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: NoZipf(real(seed).bit_generator))
    got = data.make_synthetic_ctr(num_rows=4000, field_sizes=(50, 7, 300), num_dense=1, seed=2)
    monkeypatch.setattr(np.random, "default_rng", real)
    _assert_same(got, jax_data.make_synthetic_ctr(num_rows=4000, field_sizes=(50, 7, 300),
                                                  num_dense=1, seed=2))


@pytest.mark.parametrize("rows,seed", [(300, 7), (257, 11)])
def test_generate_writes_the_same_bytes(tmp_path, rows, seed):
    mine = make_criteo_sample.generate(rows, str(tmp_path / "a" / "port.tsv"), seed=seed)
    ref = jax_sample.generate(rows, str(tmp_path / "b" / "jax.tsv"), seed=seed)
    with open(mine, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()


def test_the_bundled_sample_is_what_generate_writes(tmp_path):
    mine = make_criteo_sample.generate(path=str(tmp_path / "s.tsv"))
    with open(mine, "rb") as f, open(SAMPLE, "rb") as g:
        assert f.read() == g.read()


TOKENS = ["b", "a", 3, "b", "zz", 3, None, "a"]


def test_index_field():
    outs = []
    for mod in (data, jax_data):
        f = mod.IndexField(unk_token="<u>", unk_index=0)
        f.build_vocab(TOKENS[:4])
        outs.append((f.fit_predict(TOKENS), f.to_index(["a", "new", 3]), f.from_index([0, 2, 9]),
                     len(f), f.current_max_index, dict(f.vocab), dict(f.inverse)))
    _assert_same(*outs)


SENTENCES = ["The cat sat", "the dog", "a cat a dog a bird", "", "Cat"]


@pytest.mark.parametrize("threshold,max_length", [(0, None), (2, 3), (1, 1)])
def test_sentence_field(threshold, max_length):
    outs = []
    for mod in (data, jax_data):
        f = mod.SentenceField(threshold=threshold).build_vocab(SENTENCES)
        idx, lengths = f.to_index(SENTENCES + ["unseen words here"], max_length=max_length)
        outs.append((idx, lengths, f.from_index(idx), dict(f.vocab), f.pad_index, f.unk_index))
    _assert_same(*outs)


def _rows(rng, n=10):
    return [{"price": float(rng.normal()), "user": f"u{int(rng.integers(0, 4))}",
             "items": [int(x) for x in rng.integers(0, 9, int(rng.integers(0, 5)))],
             "tags": [f"t{int(x)}" for x in rng.integers(0, 3, int(rng.integers(1, 4)))],
             "img": rng.integers(0, 256, (4, 3, 3)).astype(np.uint8),
             "img_f": rng.uniform(size=(2, 2, 1)).astype(np.float32)}
            for _ in range(n)]


def _schema(mod):
    return {
        "price": mod.FieldSpec("values"),
        "user": mod.FieldSpec("indices", vocab=mod.IndexField()),
        "items": mod.FieldSpec("indices", max_length=3),
        "tags": mod.FieldSpec("indices", vocab=mod.IndexField(), max_length=2, dtype=np.int64),
        "img": mod.FieldSpec("images", transform=lambda a: a * 2.0),
        "img_f": mod.FieldSpec("images"),
    }


def test_collate_function_and_summary():
    rows = _rows(np.random.default_rng(0))
    outs = []
    for mod in (data, jax_data):
        fn = mod.CollateFunction(_schema(mod))
        outs.append((fn.to_batch(rows[:6]), fn.to_batch(rows[6:]), fn.summary()))
    _assert_same(*outs)
    with pytest.raises(ValueError, match="unknown field_type"):
        data.CollateFunction({"x": data.FieldSpec("nope")}).to_batch([{"x": 1}])


def test_collate_image_path_needs_pil(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "PIL", None)
    fn = data.CollateFunction({"img": data.FieldSpec("images")})
    with pytest.raises(ImportError, match="Pillow"):
        fn.to_batch([{"img": str(tmp_path / "x.png")}])


def test_collate_image_path_loads_through_pil(tmp_path):
    from PIL import Image

    path = str(tmp_path / "x.png")
    Image.fromarray(np.random.default_rng(1).integers(0, 256, (5, 4, 3)).astype(np.uint8)).save(path)
    outs = [mod.CollateFunction({"img": mod.FieldSpec("images")}).to_batch([{"img": path}])
            for mod in (data, jax_data)]
    _assert_same(*outs)


@pytest.mark.parametrize("source", ["ndarray", "frame"])
@pytest.mark.parametrize("shuffle,drop_last", [(False, True), (True, True), (True, False)])
def test_data_loader_over_both_datasets(source, shuffle, drop_last):
    rng = np.random.default_rng(2)
    arr = rng.integers(0, 50, (23, 3))
    outs = []
    for mod in (data, jax_data):
        if source == "ndarray":
            ds = mod.NdarrayToDataset(arr, columns=["a", "b", "c"])
            collate = None
        else:
            ds = mod.DataFrameToDataset(pd.DataFrame(arr, columns=["a", "b", "c"]),
                                        columns=["c", "a"])
            collate = mod.CollateFunction({"c": mod.FieldSpec("values"),
                                           "a": mod.FieldSpec("indices")})
        loader = mod.DataLoader(ds, batch_size=5, collate_fn=collate, shuffle=shuffle,
                                drop_last=drop_last, seed=3)
        outs.append((len(ds), len(loader), list(loader), list(loader), ds[4]))
    _assert_same(*outs)
    with pytest.raises(ValueError, match="2-D"):
        data.NdarrayToDataset(np.zeros(3))


@pytest.mark.parametrize("formula", ["code", "paper"])
@pytest.mark.parametrize("source", ["ndarray", "frame"])
def test_sub_sampling(formula, source):
    rng = np.random.default_rng(5)
    arr = np.stack([np.minimum(rng.zipf(1.5, 4000), 30), rng.integers(0, 9, 4000)], axis=1)
    if source == "ndarray":
        outs = [mod.sub_sampling(arr, 0, formula=formula, threshold=1e-2, seed=6)
                for mod in (data, jax_data)]
        _assert_same(*outs)
    else:
        frame = pd.DataFrame(arr, columns=["k", "v"])
        got, want = (mod.sub_sampling(frame, "k", formula=formula, threshold=1e-2, seed=6)
                     for mod in (data, jax_data))
        pd.testing.assert_frame_equal(got, want)
    with pytest.raises(ValueError, match="formula"):
        data.sub_sampling(arr, 0, formula="other")


def _columns(frame):
    return {c: frame[c].to_numpy() for c in frame.columns}


def test_load_criteo_data_and_batches_match_the_pandas_loader():
    for nrows in (None, 100):
        _assert_same(sample_data.load_criteo_data(SAMPLE, nrows=nrows),
                     _columns(jax_sd.load_criteo_data(SAMPLE, nrows=nrows)))
    hashes = tuple(100 + f for f in range(26))
    _assert_same(sample_data.load_criteo_batches(SAMPLE, hashes, nrows=300),
                 jax_sd.load_criteo_batches(SAMPLE, hashes, nrows=300))


def _write_movielens(directory):
    rng = np.random.default_rng(8)
    rows = [(int(rng.integers(1, 50)), int(rng.integers(1, 90)), int(rng.integers(1, 6)),
             int(rng.integers(8e8, 9e8))) for _ in range(40)]
    os.makedirs(os.path.join(directory, "ml-100k"))
    os.makedirs(os.path.join(directory, "ml-1m"))
    os.makedirs(os.path.join(directory, "ml-latest-small"))
    with open(os.path.join(directory, "ml-100k", "u.data"), "w") as f:
        f.writelines("\t".join(map(str, r)) + "\n" for r in rows)
    with open(os.path.join(directory, "ml-1m", "ratings.dat"), "w") as f:
        f.writelines("::".join(map(str, r)) + "\n" for r in rows)
    with open(os.path.join(directory, "ml-latest-small", "ratings.csv"), "w") as f:
        f.write("userId,movieId,rating,timestamp\n")
        f.writelines(f"{u},{i},{r / 2},{t}\n" for u, i, r, t in rows)


@pytest.mark.parametrize("size", ["100k", "1m", "latest-small"])
def test_load_ml_data_matches_the_pandas_loader(tmp_path, size):
    _write_movielens(str(tmp_path))
    _assert_same(sample_data.load_ml_data(str(tmp_path), size),
                 _columns(jax_sd.load_ml_data(str(tmp_path), size)))


def test_load_bx_data_matches_the_pandas_loader(tmp_path):
    text = ('"User-ID";"ISBN";"Book-Rating"\n"276725";"034545104X";"0"\n'
            '"276726";"0155061224";"5"\n"276727";"0446520802";"0"\n'
            '"278418";"0061098795";"7"\n"276729";"052165615X";"3"\n')
    with open(tmp_path / "BX-Book-Ratings.csv", "w", encoding="latin-1") as f:
        f.write(text.replace("276729", "2767\xe9"))
    _assert_same(sample_data.load_bx_data(str(tmp_path)),
                 _columns(jax_sd.load_bx_data(str(tmp_path))))


def test_read_table_types_columns_as_a_csv_reader_does(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("i,f,m,s,b,e,label\n1,0.5,3,x,True,,0\n-2,1e3,,y,False,,1\n+7,2,5,,True,,0\n")
    _assert_same(sample_data.read_table(str(path)), _columns(pd.read_csv(path)))
