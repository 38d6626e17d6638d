"""The port's on-device dedup chain, row-wise optimizers and the plain
versions of its last two kernels against the JAX package, on the CPU.

* ``prefix_sum``, ``sort_slot_grads``, ``dedup_sum*`` and
  ``_combine_sorted_stored`` against their JAX functions, on Zipf ids with
  heavy duplicates (so the stable sort's order matters): ids exact, sums
  rtol 1e-6.
* ``update_sorted`` of every rule, on both settings of
  ``TORECSYS_TPU_FUSED_DEDUP``, against the JAX ``update_sorted`` on the
  same switch, its kernels in interpret mode: rtol 1e-6.
* ``fused_sorted_dedup_update`` against the Pallas kernel in interpret mode
  on the id streams of the JAX package's own test (``tests/test_sparse.py``):
  rtol 2e-4, atol 1e-5, that test's tolerance for its matrix-unit combine
  order.
* ``fused_sorted_dedup_update`` on the sweep streams of the segment sums
  (``test_torch_kernels.sweep_segments``) laid out as stored rows, and on a
  sentinel tail, at P = 8 and P = 1, against the same Pallas kernel with the
  same tolerance: the streams ``chip_smoke.py`` holds the card's kernel to.
* ``unique_stored_gather`` against the Pallas kernel in interpret mode: the
  valid prefix exact (a gather is a copy), on Zipf ids and on valid
  prefixes of several lengths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torecsys_tpu.ops import sparse as jsp
from torecsys_tpu.ops.embedding import pack_table as jax_pack_table
from torecsys_tpu.ops.embedding import packed_shape
from torecsys_tpu.ops.pallas import embedding as pe
from torecsys_tpu.ops.pallas.sparse_update import fused_sorted_dedup_update as jax_fused_dedup
from torecsys_tpu.parallel.lookup import _dedup_ids
from torecsys_tpu_torch.convert import copy_row_slots
from torecsys_tpu_torch.ops import sparse as sp
from torecsys_tpu_torch.ops.kernels import embedding as KE
from torecsys_tpu_torch.ops.kernels import sparse_update as K

from test_torch_kernels import SWEEP_STREAMS, sweep_segments

RULES = {"adam": "adamw", "adagrad": "adagrad", "sgd": "sgd"}


def _t(x):
    return torch.from_numpy(np.array(x))


def _zipf_ids(rng, shape, rows):
    return np.minimum(rng.zipf(1.3, shape) - 1, rows - 1).astype(np.int32)


def _state(rng, rule, rows, w):
    """A table and random row slots of ``rule`` (numpy)."""
    table = rng.normal(0, 0.1, (rows, w)).astype(np.float32)
    if rule == "adam":
        return table, {"mv": np.stack([rng.normal(0, 1e-3, (rows, w)),
                                       rng.uniform(0, 1e-5, (rows, w))], axis=1).astype(np.float32)}
    if rule == "adagrad":
        return table, {"v": rng.uniform(0.1, 1.0, (rows, w)).astype(np.float32)}
    return table, {}


def _port_state(table, slots, port_tx):
    t_table = torch.from_numpy(table.copy())
    t_slots = port_tx.init(t_table)
    copy_row_slots(slots, t_slots)
    return t_table, t_slots


def test_prefix_sum_matches_jax():
    x = np.random.default_rng(0).integers(0, 3, 1500).astype(np.int32)
    got = sp.prefix_sum(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsp.prefix_sum(jnp.asarray(x))))


def test_sort_slot_grads_matches_jax_stably():
    rng = np.random.default_rng(1)
    ids = _zipf_ids(rng, (64, 7), 50)  # id 0 alone fills about a third of the slots
    g = rng.normal(size=(64, 7, 16)).astype(np.float32)
    ref_ids, ref_g = jsp.sort_slot_grads(jnp.asarray(ids), jnp.asarray(g))
    got_ids, got_g = sp.sort_slot_grads(torch.from_numpy(ids.astype(np.int64)), _t(g))
    assert got_ids.dtype == torch.int32
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(ref_g))


def test_dedup_sum_matches_jax():
    rng = np.random.default_rng(2)
    ids = _zipf_ids(rng, (300,), 80)
    g = rng.normal(size=(300, 16)).astype(np.float32)
    ref_u, ref_g = jsp.dedup_sum(jnp.asarray(ids), jnp.asarray(g), 80)
    got_u, got_g = sp.dedup_sum(_t(ids), _t(g), 80)
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(ref_u))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(ref_g), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pack", [1, 8])
def test_dedup_sum_stored_matches_jax(pack):
    rng = np.random.default_rng(3 + pack)
    rows = 400
    vp = -(-rows // pack)
    ids = _zipf_ids(rng, (500,), rows)
    g = rng.normal(size=(500, 128 // pack)).astype(np.float32)
    ref_u, ref_g = jsp.dedup_sum_stored(jnp.asarray(ids), jnp.asarray(g), pack, vp)
    got_u, got_g = sp.dedup_sum_stored(_t(ids), _t(g), pack, vp)
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(ref_u))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(ref_g), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pack", [1, 2, 8])
def test_dedup_sum_fields_and_combine_match_jax(pack):
    rng = np.random.default_rng(10 + pack)
    rows, e = 700, 128 // pack
    vp = -(-rows // pack)
    ids = _zipf_ids(rng, (96, 5), rows)
    g = rng.normal(size=(96, 5, e)).astype(np.float32)
    ref_u, ref_g = jsp.dedup_sum_fields(jnp.asarray(ids), jnp.asarray(g), pack, vp)
    got_u, got_g = sp.dedup_sum_fields(_t(ids), _t(g), pack, vp)
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(ref_u))
    n = int((np.asarray(ref_u) < vp).sum())
    # Past the last segment the JAX fallback's rows are zero, as the port's.
    np.testing.assert_allclose(got_g.numpy(), np.asarray(ref_g), rtol=1e-6, atol=1e-6)

    s_ids, s_g = jsp.sort_slot_grads(jnp.asarray(ids), jnp.asarray(g))
    ref_u2, ref_g2 = jsp._combine_sorted_stored(s_ids, s_g, pack, vp)
    uids, gsum, n_unique = sp._combine_sorted_stored(_t(s_ids), _t(s_g), pack, vp)
    assert n_unique.dtype == torch.int32 and n_unique.dim() == 0 and int(n_unique) == n
    np.testing.assert_array_equal(uids.numpy(), np.asarray(ref_u2))
    np.testing.assert_allclose(gsum.numpy(), np.asarray(ref_g2), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("rule", sorted(RULES))
def test_update_sorted_matches_jax(rule, fused, monkeypatch):
    """Both switches of the port against the JAX ``update_sorted`` on the
    same switch, from one state; the optimizer comes from each package's
    registry (``adamw``: optax's default weight decay).  The JAX side runs
    its Pallas kernels in interpret mode, as its TPU runs them (its fused
    branch takes interpret mode from ``interpret=True``): its XLA
    fallback takes ``1 - b2`` in float64 where every kernel of both packages
    takes it from the float32 ``hyper``, 1e-5 apart."""
    monkeypatch.setenv("TORECSYS_TPU_SPARSE_INTERPRET", "1")
    monkeypatch.setenv("TORECSYS_TPU_FUSED_DEDUP", "1" if fused else "0")
    calls = []
    real = K.fused_sorted_dedup_update
    monkeypatch.setattr(K, "fused_sorted_dedup_update",
                        lambda *a: calls.append(1) or real(*a))
    rng = np.random.default_rng(20)
    rows, e, step = 500, 16, 3
    vp, w = packed_shape(rows, e)
    table, slots = _state(rng, rule, vp, w)
    ids = _zipf_ids(rng, (48, 6), rows)
    g = rng.normal(0, 1e-2, (48, 6, e)).astype(np.float32)

    jtx = jsp.get_row_optimizer(RULES[rule], lr=1e-2)
    s_ids, s_g = jsp.sort_slot_grads(jnp.asarray(ids), jnp.asarray(g))
    ref_t, ref_s = jtx.update_sorted(jnp.asarray(table),
                                     {k: jnp.asarray(v) for k, v in slots.items()},
                                     s_ids, s_g, jnp.int32(step), interpret=fused)

    tx = sp.get_row_optimizer(RULES[rule], lr=1e-2)
    assert type(tx).__name__ == type(jtx).__name__
    t_table, t_slots = _port_state(table, slots, tx)
    p_ids, p_g = sp.sort_slot_grads(_t(ids), _t(g))
    got_t, got_s = tx.update_sorted(t_table, t_slots, p_ids, p_g,
                                    torch.tensor(step, dtype=torch.int32))
    assert got_t is t_table and len(calls) == int(fused)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), rtol=1e-6, atol=1e-8)
    for k in slots:
        np.testing.assert_allclose(got_s[k].numpy(), np.asarray(ref_s[k]), rtol=1e-6,
                                   atol=1e-10)


def _dedup_streams():
    rng = np.random.default_rng(0)
    dup = rng.integers(0, 300, 700)  # < one tile, heavy duplication
    carry = np.concatenate([np.full(900, 7), rng.integers(0, 2000, 500)])
    return [
        *[pytest.param(rule, dup, 300, id=f"duplicates-{rule}") for rule in sorted(RULES)],
        pytest.param("adam", carry, 2000, id="cross-tile-carry"),
        pytest.param("adam", np.concatenate([np.full(1600, 42), np.arange(100)]), 4096,
                     id="segment-spanning-three-tiles"),
        pytest.param("adagrad", np.arange(777) * 3 % 2048, 2048, id="all-unique-padded-tail"),
    ]


@pytest.mark.parametrize("rule,ids,total_rows", _dedup_streams())
def test_fused_sorted_dedup_update_matches_pallas(rule, ids, total_rows):
    rng = np.random.default_rng(7)
    e = 16
    vp, w = packed_shape(total_rows, e)
    pack = w // e
    table, slots = _state(rng, rule, vp, w)
    sorted_ids = np.sort(ids.astype(np.int32))
    g = rng.normal(size=(sorted_ids.shape[0], e)).astype(np.float32)
    jtx = {"adam": jsp.RowAdam(learning_rate=1e-2, weight_decay=1e-4),
           "adagrad": jsp.RowAdagrad(learning_rate=1e-2),
           "sgd": jsp.RowSGD(learning_rate=1e-2)}[rule]
    hyper, rl = jtx.hyper_and_rule(jnp.int32(2))
    j_slots = {k: jnp.asarray(v) for k, v in slots.items()}
    ref_t, ref_s = jax_fused_dedup(jnp.asarray(sorted_ids), jnp.asarray(g), jnp.asarray(table),
                                   jtx._slot_tuple(j_slots, w), hyper, pack, rl,
                                   interpret=True)

    tx = sp.get_row_optimizer(RULES[rule], lr=1e-2)
    t_table, t_slots = _port_state(table, slots, tx)
    got_t, got_s = K.fused_sorted_dedup_update(_t(sorted_ids), _t(g), t_table,
                                               tx._slot_tuple(t_slots, w), _t(hyper), pack, rl)
    assert got_t is t_table
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), rtol=2e-4, atol=1e-5)
    for got, ref in zip(got_s, ref_s):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=1e-5)
    touched = np.unique(sorted_ids // pack)
    untouched = np.setdiff1d(np.arange(vp), touched)
    np.testing.assert_array_equal(got_t.numpy()[untouched], table[untouched])


def _dedup_sweep_ids(stream, pack, rng):
    """Logical ids of a sweep stream and the table rows R they address, as
    ``chip_smoke.py`` lays them: group s is stored row 2s + 1 (the even rows
    stay untouched) with ascending in-row slots; "sentinel tail" is the Zipf
    stream with its last M/4 ids turned into sentinels >= R*P, three to a
    logical id."""
    seg = sweep_segments("zipf" if stream == "sentinel tail" else stream, rng)
    m = seg.shape[0]
    rows = 2 * m + 2
    ids = np.sort((2 * seg.astype(np.int64) + 1) * pack + rng.integers(0, pack, m))
    if stream == "sentinel tail":
        tail = m // 4
        ids[m - tail:] = rows * pack + np.arange(tail) // 3
    return ids.astype(np.int32), rows


@pytest.mark.parametrize("pack", [1, 8])
@pytest.mark.parametrize("stream", SWEEP_STREAMS + ["sentinel tail"])
def test_fused_sorted_dedup_update_sweep_streams(stream, pack):
    rng = np.random.default_rng(30 + pack)
    e = 128 // pack
    w = pack * e
    ids, rows = _dedup_sweep_ids(stream, pack, rng)
    table, slots = _state(rng, "adam", rows, w)
    g = rng.normal(size=(ids.shape[0], e)).astype(np.float32)
    jtx = jsp.RowAdam(learning_rate=1e-2, weight_decay=1e-4)
    hyper, rl = jtx.hyper_and_rule(jnp.int32(2))
    ref_t, ref_s = jax_fused_dedup(jnp.asarray(ids), jnp.asarray(g), jnp.asarray(table),
                                   jtx._slot_tuple({"mv": jnp.asarray(slots["mv"])}, w), hyper,
                                   pack, rl, interpret=True)

    tx = sp.get_row_optimizer("adamw", lr=1e-2)
    t_table, t_slots = _port_state(table, slots, tx)
    got_t, got_s = K.fused_sorted_dedup_update(_t(ids), _t(g), t_table,
                                               tx._slot_tuple(t_slots, w), _t(hyper), pack, rl)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(got_s[0].numpy(), np.asarray(ref_s[0]), rtol=2e-4, atol=1e-5)
    hi = ids // pack
    untouched = np.setdiff1d(np.arange(rows), hi[hi < rows])
    assert untouched.size >= rows // 2
    np.testing.assert_array_equal(got_t.numpy()[untouched], table[untouched])
    np.testing.assert_array_equal(got_s[0].numpy()[untouched], slots["mv"][untouched])


def test_fused_sorted_dedup_update_skips_rows_outside_the_table():
    """A sentinel tail (>= R*P) and a negative id touch no row; the rest is
    updated as without them."""
    rng = np.random.default_rng(8)
    rows, e, pack = 6, 16, 8
    table, _ = _state(rng, "sgd", rows, pack * e)
    hyper = torch.tensor([0.5, 0, 0, 0, 0, 1, 1], dtype=torch.float32)
    ids = np.array([-3, 0, 0, 9, 17, 17, 47, rows * pack, rows * pack + 5], np.int32)
    g = rng.normal(size=(ids.shape[0], e)).astype(np.float32)
    got = torch.from_numpy(table.copy())
    K.fused_sorted_dedup_update(_t(ids), _t(g), got, [], hyper, pack, "sgd")
    want = torch.from_numpy(table.copy())
    K.fused_sorted_dedup_update(_t(ids[1:7]), _t(g[1:7]), want, [], hyper, pack, "sgd")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    changed = (got.numpy() != table).any(axis=1)
    np.testing.assert_array_equal(np.flatnonzero(changed), [0, 1, 2, 5])


@pytest.mark.parametrize("e", [16, 128])
def test_unique_stored_gather_matches_pallas(e):
    rng = np.random.default_rng(9)
    v = 5000
    packed = jax_pack_table(jnp.asarray(rng.normal(size=(v, e)).astype(np.float32)))
    num_logical = packed.shape[0] * (packed.shape[1] // e)
    uids, _, _ = _dedup_ids(jnp.asarray(rng.integers(0, v, 3000).astype(np.int32)))
    uids = jnp.minimum(uids, num_logical)  # INT32_MAX sentinel -> the kernel's
    n = int((np.asarray(uids) < num_logical).sum())
    ref = np.asarray(pe.unique_stored_gather(packed, uids, e, interpret=True))
    got = KE.unique_stored_gather(_t(packed), _t(uids), e)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy()[:n], ref[:n])


@pytest.mark.parametrize("n_valid", [3000, 1, 1013],
                         ids=["all valid", "single valid", "prefix ends mid-block"])
def test_unique_stored_gather_valid_prefixes(n_valid):
    """Valid prefixes of every length class the card's grid meets: all M ids,
    one id, and a prefix that ends inside a block's and a warp's share."""
    rng = np.random.default_rng(40)
    e, v, m = 16, 50_000, 3000
    packed = jax_pack_table(jnp.asarray(rng.normal(size=(v, e)).astype(np.float32)))
    num_logical = packed.shape[0] * (packed.shape[1] // e)
    uids = np.full(m, num_logical, np.int32)
    uids[:n_valid] = np.sort(rng.choice(v, n_valid, replace=False))
    ref = np.asarray(pe.unique_stored_gather(packed, jnp.asarray(uids), e, interpret=True))
    got = KE.unique_stored_gather(_t(packed), _t(uids), e)
    assert got.shape == ref.shape == (m, packed.shape[1])
    np.testing.assert_array_equal(got.numpy()[:n_valid], ref[:n_valid])


def test_fused_rowwise_update_takes_a_device_count():
    """A 0-d int32 count and None (every uid; the sentinel tail is skipped)
    give what the host count gives."""
    rng = np.random.default_rng(4)
    rows, w, m, n = 30, 128, 64, 17
    uids = np.full(m, rows, np.int32)
    uids[:n] = np.sort(rng.choice(rows, n, replace=False))
    gsum = rng.normal(size=(m, w)).astype(np.float32)
    table, slots = _state(rng, "adam", rows, w)
    hyper = torch.tensor([0.05, 0.9, 0.999, 1e-8, 0, 2.0, 30.0], dtype=torch.float32)
    outs = []
    for count in (n, torch.tensor(n, dtype=torch.int32), None):
        t, mv = torch.from_numpy(table.copy()), torch.from_numpy(slots["mv"].copy())
        K.fused_rowwise_update(_t(uids), _t(gsum), t, [mv], hyper, "adam", count)
        outs.append((t, mv))
    for t, mv in outs[1:]:
        torch.testing.assert_close(t, outs[0][0], rtol=0, atol=0)
        torch.testing.assert_close(mv, outs[0][1], rtol=0, atol=0)
    with pytest.raises(ValueError, match="0-d int32"):
        K.fused_rowwise_update(_t(uids), _t(gsum), t, [mv], hyper, "adam",
                               torch.tensor([n], dtype=torch.int64))


@pytest.mark.parametrize("name,kwargs", [("adam", {}), ("AdamW", {}), ("adamw", {"b1": 0.8}),
                                         ("adagrad", {"eps": 1e-6}), ("sgd", {}),
                                         ("sgd", {"momentum": 0.9}), ("adam", {"momentum": 0.9}),
                                         ("lamb", {})])
def test_row_optimizer_registry_matches_jax(name, kwargs):
    ref = jsp.get_row_optimizer(name, lr=0.02, **kwargs)
    got = sp.get_row_optimizer(name, lr=0.02, **kwargs)
    if ref is None:
        assert got is None
        return
    assert type(got).__name__ == type(ref).__name__
    assert got.__dict__ == ref.__dict__


@pytest.mark.parametrize("rule", sorted(RULES))
def test_row_init_and_hyper_match_jax(rule):
    jtx = jsp.get_row_optimizer(RULES[rule], lr=0.03)
    tx = sp.get_row_optimizer(RULES[rule], lr=0.03)
    table = np.zeros((5, 128), np.float32)
    ref_slots, got_slots = jtx.init(jnp.asarray(table)), tx.init(torch.from_numpy(table))
    assert sorted(got_slots) == sorted(ref_slots)
    for k in ref_slots:
        np.testing.assert_array_equal(got_slots[k].numpy(), np.asarray(ref_slots[k]))
    ref_h, ref_rule = jtx.hyper_and_rule(jnp.int32(7))
    got_h, got_rule = tx.hyper_and_rule(torch.tensor(7, dtype=torch.int32))
    assert got_rule == ref_rule == rule
    np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_h), rtol=1e-6)


def test_copy_row_slots_checks_names_and_shapes():
    slots = sp.RowAdagrad().init(torch.zeros(3, 128))
    copy_row_slots({"v": np.full((3, 128), 0.5, np.float32)}, slots)
    assert bool((slots["v"] == 0.5).all())
    with pytest.raises(KeyError, match="do not match"):
        copy_row_slots({"mv": np.zeros((3, 2, 128), np.float32)}, slots)
    with pytest.raises(ValueError, match="does not fit"):
        copy_row_slots({"v": np.zeros((4, 128), np.float32)}, slots)


def test_new_kernels_reject_bad_inputs_and_count_nothing_on_the_cpu():
    before = (K.fused_sorted_dedup_update.launches, KE.unique_stored_gather.launches)
    hyper = torch.zeros(7)
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="sorted_ids"):
        K.fused_sorted_dedup_update(ids.long(), torch.zeros(4, 16), torch.zeros(2, 128), [],
                                    hyper, 8, "sgd")
    with pytest.raises(ValueError, match="table"):
        K.fused_sorted_dedup_update(ids, torch.zeros(4, 16), torch.zeros(2, 64), [], hyper, 8,
                                    "sgd")
    with pytest.raises(ValueError, match="slot"):
        K.fused_sorted_dedup_update(ids, torch.zeros(4, 16), torch.zeros(2, 128), [], hyper, 8,
                                    "adam")
    with pytest.raises(ValueError, match="int32"):
        KE.unique_stored_gather(torch.zeros(2, 128), ids.long(), 16)
    with pytest.raises(ValueError, match="multiple"):
        KE.unique_stored_gather(torch.zeros(2, 128), ids, 48)
    K.fused_sorted_dedup_update(ids, torch.ones(4, 16), torch.zeros(2, 128), [], hyper, 8, "sgd")
    KE.unique_stored_gather(torch.zeros(2, 128), ids, 16)
    assert (K.fused_sorted_dedup_update.launches, KE.unique_stored_gather.launches) == before
