"""The port's host presort against the JAX package's, on the same batches,
and the presort hazards the port decides: an empty id stream and ids
outside the table are refused before the trusted device route sees them."""

import dataclasses

import numpy as np
import pytest

from torecsys_tpu.data import presort as jax_presort
from torecsys_tpu.inputs import MultiIndicesEmbedding as JaxMultiIndicesEmbedding
from torecsys_tpu_torch.data import presort
from torecsys_tpu_torch.inputs import MultiIndicesEmbedding

AUX = presort.AUX_NAMES


def _batch(rng, field_sizes, b):
    return {f"c{i}": np.minimum(rng.zipf(1.2, b) - 1, v - 1).astype(np.int32)
            for i, v in enumerate(field_sizes)}


@pytest.mark.parametrize("pack", [1, 2, 4, 8])
@pytest.mark.parametrize("field_sizes", [(7,), (1000, 500, 200, 20), (3_000_000, 17, 1)])
def test_presort_numpy_bit_identical(pack, field_sizes):
    rng = np.random.default_rng(pack * 100 + len(field_sizes))
    fields = tuple(f"c{i}" for i in range(len(field_sizes)))
    offs = tuple(int(o) for o in np.concatenate([[0], np.cumsum(field_sizes)[:-1]]))
    vp = -(-sum(field_sizes) // pack)
    spec = presort.PresortSpec(fields, offs, pack, vp, sum(field_sizes))
    batch = _batch(rng, field_sizes, 333)
    got = presort.Presorter([spec])(batch)
    flat = (np.stack([batch[f] for f in fields], 1) + np.asarray(offs)[None]).reshape(-1)
    ref = jax_presort._presort_numpy(flat.astype(np.int32), pack, vp)
    for name, want in zip(AUX, ref):
        have = got[spec.aux_key(name)]
        if name == "n_unique":
            assert have.shape == (1,) and have.dtype == np.int32 and have[0] == want
        else:
            assert have.dtype == want.dtype
            np.testing.assert_array_equal(have, want)


def test_spec_and_aux_keys_match_the_jax_package():
    sizes, fields = (1000, 500, 20), ("a", "b", "c")
    port = MultiIndicesEmbedding(16, sizes, fields, device="cpu")
    flax_mod = JaxMultiIndicesEmbedding(embed_size=16, field_sizes=sizes, fields=fields)
    spec = presort.spec_for_module(port)
    ref_spec = jax_presort.spec_for_module(flax_mod)
    assert dataclasses.astuple(spec)[:4] == dataclasses.astuple(ref_spec)
    assert spec.num_rows == sum(sizes)
    assert spec.key == ref_spec.key
    rng = np.random.default_rng(0)
    batch = {f: rng.integers(0, v, 64).astype(np.int32) for f, v in zip(fields, sizes)}
    got = presort.Presorter([spec])(batch)
    ref = jax_presort.Presorter([spec], force_numpy=True)(batch)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


def test_build_presort_specs_walks_the_inputs_tree():
    from torecsys_tpu_torch.inputs import Inputs, ValueInput

    inputs = Inputs({"feat_inputs": ValueInput(("d",)),
                     "emb_inputs": MultiIndicesEmbedding(8, (10, 20), ("a", "b"),
                                                         device="cpu")})
    (spec,) = presort.build_presort_specs(inputs)
    assert spec.slot_fields == ("a", "b") and spec.pack == 16


def _spec():
    # V = 30 logical rows, stored as 8 rows of 4: rows 30 and 31 are padding
    return presort.PresortSpec(("a", "b"), (0, 10), 4, 8, 30)


def test_presort_refuses_empty_stream():
    with pytest.raises(ValueError, match="empty"):
        presort.Presorter([_spec()])({"a": np.zeros(0, np.int32), "b": np.zeros(0, np.int32)})


@pytest.mark.parametrize("field,bad", [("a", -1), ("b", -11), ("b", 20), ("b", 22),
                                       ("b", (1 << 31) - 1)])
def test_presort_refuses_ids_outside_the_table(field, bad):
    # field b is shifted by 10: raw id 20 lands on logical row 30 == V, a
    # padding row of the packed table; raw id 22 lands past the stored rows
    batch = {"a": np.array([0, 1], np.int64), "b": np.array([3, 4], np.int64)}
    batch[field][1] = bad
    with pytest.raises(ValueError, match="outside"):
        presort.Presorter([_spec()])(batch)


def test_presort_skips_batches_without_the_fields():
    batch = {"a": np.array([1, 2], np.int32)}
    assert presort.Presorter([_spec()])(batch) == batch
