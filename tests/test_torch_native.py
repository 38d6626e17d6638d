"""The port's C++ presort (``data/native/id_preprocess.cc``) against its
numpy path and the JAX package's ``Presorter`` (C++ and numpy), bit for bit;
the refusals it keeps in front of the C++ call; and the numpy fallback where
no compiler builds it."""

import logging

import numpy as np
import pytest

from torecsys_tpu.data import presort as jax_presort
from torecsys_tpu.data.native import presort_lib as jax_presort_lib
from torecsys_tpu_torch.data import native, presort

AUX = presort.AUX_NAMES


def _spec(sizes, pack):
    offs = tuple(int(o) for o in np.concatenate([[0], np.cumsum(sizes)[:-1]]))
    vp = -(-int(sum(sizes)) // pack)
    return presort.PresortSpec(tuple(f"f{i}" for i in range(len(sizes))), offs, pack, vp,
                               int(sum(sizes)))


# tests/test_presort.py's matrix: single-field streams, size-1 vocabs, a
# 3M-row vocab (three radix passes) and packs 1, 2, 4 and 8
CASES = [([100, 50, 4000, 8, 300, 77], 512, 8), ([1], 256, 1), ([1, 1, 1], 128, 4),
         ([3_000_000, 9], 1024, 2), ([65536] * 4, 333, 8)]


@pytest.mark.parametrize("sizes,b,pack", CASES)
def test_native_presort_is_bit_identical_to_numpy_and_the_jax_package(sizes, b, pack):
    assert jax_presort_lib() is not None, "this rig has g++"
    rng = np.random.default_rng(pack * 1000 + b)
    spec = _spec(sizes, pack)
    batch = {f"f{i}": rng.integers(0, s, b).astype(np.int32) for i, s in enumerate(sizes)}
    port_native = presort.Presorter([spec])
    assert port_native.native
    outs = [port_native(dict(batch)), presort.Presorter([spec], force_numpy=True)(dict(batch))]
    jax_spec = jax_presort.PresortSpec(spec.slot_fields, spec.slot_offsets, spec.pack,
                                       spec.num_stored_rows)
    outs += [jax_presort.Presorter([jax_spec])(dict(batch)),
             jax_presort.Presorter([jax_spec], force_numpy=True)(dict(batch))]
    ref = outs[0]
    for out in outs[1:]:
        assert set(out) == set(ref)
        for name in AUX:
            have, want = out[spec.aux_key(name)], ref[spec.aux_key(name)]
            assert have.dtype == want.dtype == np.int32 and have.shape == want.shape
            np.testing.assert_array_equal(have, want, err_msg=name)


def _two_field_spec():
    # V = 30 logical rows, stored as 8 rows of 4: rows 30 and 31 are padding
    return presort.PresortSpec(("a", "b"), (0, 10), 4, 8, 30)


@pytest.mark.parametrize("force_numpy", [False, True])
@pytest.mark.parametrize("field,bad", [("a", -1), ("b", -11), ("b", 20), ("b", (1 << 31) - 1),
                                       ("a", -(1 << 31))])
def test_both_routes_refuse_ids_outside_the_table(force_numpy, field, bad):
    """The int64 [0, V) check stands in front of the C++ call, which would
    cast a negative id to uint32."""
    batch = {"a": np.array([0, 1], np.int64), "b": np.array([3, 4], np.int64)}
    batch[field][1] = bad
    sorter = presort.Presorter([_two_field_spec()], force_numpy=force_numpy)
    assert sorter.native is not force_numpy
    with pytest.raises(ValueError, match="outside"):
        sorter(batch)


@pytest.mark.parametrize("force_numpy", [False, True])
def test_both_routes_refuse_an_empty_stream(force_numpy):
    sorter = presort.Presorter([_two_field_spec()], force_numpy=force_numpy)
    with pytest.raises(ValueError, match="empty"):
        sorter({"a": np.zeros(0, np.int32), "b": np.zeros(0, np.int32)})


@pytest.mark.parametrize("num_rows,num_stored", [(2**31, 2**28), (2**31 - 1, 2**31), (0, 1)])
def test_presorter_refuses_a_spec_outside_int32(num_rows, num_stored):
    spec = presort.PresortSpec(("a",), (0,), 8, num_stored, num_rows)
    with pytest.raises(ValueError, match="int32"):
        presort.Presorter([spec])


def test_without_a_compiler_the_presort_falls_back_to_numpy(monkeypatch, tmp_path, caplog):
    def no_compiler(*args, **kwargs):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.subprocess, "run", no_compiler)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        sorter = presort.Presorter([_spec([50, 7], 4)])
    assert not sorter.native
    assert "presorting with numpy" in caplog.text
    rng = np.random.default_rng(0)
    batch = {"f0": rng.integers(0, 50, 64).astype(np.int32),
             "f1": rng.integers(0, 7, 64).astype(np.int32)}
    monkeypatch.undo()
    got, want = sorter(batch), presort.Presorter([_spec([50, 7], 4)])(batch)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_the_library_is_named_by_its_source_and_flags():
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libid_preprocess_")
    assert native.presort_lib() is not None and path.exists()
