"""The port's row-wise Adam (``ops/sparse.py``) against the JAX package's on
the trusted presorted route, from the same table, moments, grads and aux."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torecsys_tpu.data.presort import Presorter as JaxPresorter
from torecsys_tpu.data.presort import PresortSpec as JaxPresortSpec
from torecsys_tpu.ops.sparse import RowAdam as JaxRowAdam
from torecsys_tpu_torch.ops.sparse import RowAdam, get_row_optimizer

AUX = ("order", "lo", "seg", "uids", "n_unique")


def _aux(rng, b, field_sizes, pack):
    fields = tuple(f"c{i}" for i in range(len(field_sizes)))
    offs = tuple(int(o) for o in np.concatenate([[0], np.cumsum(field_sizes)[:-1]]))
    spec = JaxPresortSpec(fields, offs, pack, -(-sum(field_sizes) // pack))
    batch = {f: np.minimum(rng.zipf(1.3, b) - 1, v - 1).astype(np.int32)
             for f, v in zip(fields, field_sizes)}
    out = JaxPresorter([spec], force_numpy=True)(batch)
    return spec, {n: out[spec.aux_key(n)] for n in AUX}


@pytest.mark.parametrize("step,wd", [(0, 0.0), (6, 0.0), (6, 1e-2)])
def test_update_from_host_aux_matches_jax(step, wd):
    rng = np.random.default_rng(step)
    e, pack, field_sizes = 16, 8, (900, 300, 40)
    spec, aux = _aux(rng, 96, field_sizes, pack)
    rows, w = spec.num_stored_rows, pack * e
    table = rng.normal(0, 0.01, (rows, w)).astype(np.float32)
    mv = np.stack([rng.normal(0, 1e-3, (rows, w)), rng.uniform(0, 1e-5, (rows, w))],
                  axis=1).astype(np.float32)
    flat_g = rng.normal(0, 1e-2, (aux["order"].shape[0], e)).astype(np.float32)

    jtx = JaxRowAdam(learning_rate=1e-2, weight_decay=wd)
    ref_t, ref_s = jtx.update_from_host_aux(
        jnp.asarray(table), {"mv": jnp.asarray(mv)}, jnp.asarray(flat_g),
        {k: jnp.asarray(v) for k, v in aux.items()}, jnp.int32(step))

    tx = get_row_optimizer("Adam", lr=1e-2, weight_decay=wd)
    assert tx == RowAdam(learning_rate=1e-2, weight_decay=wd)
    t_table = torch.from_numpy(table.copy())
    slots = {"mv": torch.from_numpy(mv.copy())}
    t_aux = {k: torch.from_numpy(v) for k, v in aux.items() if k != "n_unique"}
    t_aux["n_unique"] = int(aux["n_unique"][0])
    got_t, got_s = tx.update_from_host_aux(
        t_table, slots, torch.from_numpy(flat_g), t_aux,
        torch.tensor(step, dtype=torch.int32))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got_s["mv"].numpy(), np.asarray(ref_s["mv"]),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("step", [0, 1, 99, 9999])
def test_hyper_vector_matches_jax(step):
    ref, ref_rule = JaxRowAdam(learning_rate=3e-3, weight_decay=1e-4).hyper_and_rule(
        jnp.int32(step))
    got, rule = RowAdam(learning_rate=3e-3, weight_decay=1e-4).hyper_and_rule(
        torch.tensor(step, dtype=torch.int32))
    assert rule == ref_rule == "adam"
    assert got.dtype == torch.float32 and got.shape == (7,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_row_optimizer_registry_is_adam_only():
    """The registry's Adam twin and its refusals (the Trainer now takes the
    AdamW, Adagrad and SGD twins too: ``tests/test_torch_optim_train.py``;
    ``tests/test_torch_dedup.py`` holds every rule against the JAX package's)."""
    assert get_row_optimizer("adam", learning_rate=0.5).learning_rate == 0.5
    assert type(get_row_optimizer("Adagrad")).__name__ == "RowAdagrad"
    assert get_row_optimizer("Adam", momentum=0.9) is None
    slots = RowAdam().init(torch.zeros(5, 128))
    assert slots["mv"].shape == (5, 2, 128)
