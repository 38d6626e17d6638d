"""The port's lookup, layers, model, loss and dense optimizer against the JAX
package on the same inputs; DeepFM from carried-over flax weights."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torecsys_tpu import inputs as jax_inputs
from torecsys_tpu.losses import BCEWithLogitsLoss as JaxBCE
from torecsys_tpu.models import Sequential as JaxSequential
from torecsys_tpu.models import get_model as jax_get_model
from torecsys_tpu.ops import embedding as jax_embedding
from torecsys_tpu.ops.interactions import fm_pairwise_interaction as jax_fm
from torecsys_tpu_torch import Inputs, MultiIndicesEmbedding, Pipeline, Sequential, ValueInput
from torecsys_tpu_torch.convert import from_flax_params, torch_name
from torecsys_tpu_torch.losses import BCEWithLogitsLoss
from torecsys_tpu_torch.models import get_model
from torecsys_tpu_torch.ops import embedding
from torecsys_tpu_torch.ops.interactions import fm_pairwise_interaction
from torecsys_tpu_torch.train.optimizers import get_optimizer

FIELDS = (1000, 500, 200, 30)
DENSE = 3


def _batch(rng, b=32):
    batch = {f"c{i}": np.minimum(rng.zipf(1.3, b) - 1, v - 1).astype(np.int32)
             for i, v in enumerate(FIELDS)}
    batch.update({f"d{j}": rng.normal(size=b).astype(np.float32) for j in range(DENSE)})
    return batch


@pytest.mark.parametrize("e", [4, 16, 128])
def test_packed_lookup_and_layout_match_jax(e):
    rng = np.random.default_rng(e)
    v = 1001
    logical = rng.normal(size=(v, e)).astype(np.float32)
    packed = embedding.pack_table(torch.from_numpy(logical))
    ref_packed = np.asarray(jax_embedding.pack_table(jnp.asarray(logical)))
    np.testing.assert_array_equal(packed.numpy(), ref_packed)
    assert packed.shape == embedding.packed_shape(v, e) == jax_embedding.packed_shape(v, e)
    assert embedding.pack_factor(e) == jax_embedding.pack_factor(e)
    np.testing.assert_array_equal(embedding.unpack_table(packed, e, v).numpy(), logical)
    ids = rng.integers(0, v, (9, 7))
    got = embedding.packed_lookup(packed, torch.from_numpy(ids), e)
    ref = jax_embedding.packed_lookup(jnp.asarray(ref_packed), jnp.asarray(ids), e)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(embedding.field_offsets(FIELDS),
                                  jax_embedding.field_offsets(FIELDS))


def test_fm_interaction_and_bce_match_jax():
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(8, 5, 16)).astype(np.float32)
    np.testing.assert_allclose(fm_pairwise_interaction(torch.from_numpy(emb)).numpy(),
                               np.asarray(jax_fm(jnp.asarray(emb))), rtol=1e-6, atol=1e-6)
    logits = (rng.normal(size=(64, 1)) * 4).astype(np.float32)
    labels = (rng.uniform(size=64) < 0.5).astype(np.float32)
    got = BCEWithLogitsLoss()(torch.from_numpy(logits), torch.from_numpy(labels))
    ref = JaxBCE()(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


def _flax_and_port(rng, tower=(32, 16)):
    cat = tuple(f"c{i}" for i in range(len(FIELDS)))
    dense = tuple(f"d{j}" for j in range(DENSE))
    flax_seq = JaxSequential(
        inputs=jax_inputs.Inputs(schema={
            "feat_inputs": jax_inputs.ValueInput(fields=dense),
            "emb_inputs": jax_inputs.MultiIndicesEmbedding(
                embed_size=16, field_sizes=FIELDS, fields=cat)}),
        model=jax_get_model("DeepFM", deep_layer_sizes=tower))
    batch = _batch(rng)
    params = flax_seq.init(jax.random.PRNGKey(3), {k: jnp.asarray(v) for k, v in batch.items()})
    inputs = Inputs({"feat_inputs": ValueInput(dense),
                     "emb_inputs": MultiIndicesEmbedding(16, FIELDS, cat, device="cpu")})
    port = Sequential(inputs, get_model("DeepFM", inputs=inputs, deep_layer_sizes=tower,
                                        device="cpu"))
    return flax_seq, params, port, batch


def test_deepfm_forward_from_carried_over_weights():
    flax_seq, variables, port, batch = _flax_and_port(np.random.default_rng(0))
    params_np = jax.tree_util.tree_map(np.asarray, variables["params"])
    from_flax_params(port, params_np)
    ref = flax_seq.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = port({k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == ref.shape == (32, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_carry_over_names_and_layouts():
    _, variables, port, _ = _flax_and_port(np.random.default_rng(1))
    params_np = jax.tree_util.tree_map(np.asarray, variables["params"])
    from_flax_params(port, params_np)
    kernel = params_np["model"]["deep"]["dense_0"]["kernel"]
    np.testing.assert_array_equal(port.model.deep.dense_0.weight.detach().numpy(), kernel.T)
    table = params_np["inputs"]["schema_emb_inputs"]["embedding"]
    np.testing.assert_array_equal(port.inputs.schema["emb_inputs"].embedding.detach().numpy(),
                                  table)
    assert torch_name("model/deep/output/kernel") == "model.deep.output.weight"
    bad = {**params_np, "model": {"deep": {**params_np["model"]["deep"], "extra": {
        "kernel": np.zeros((2, 2), np.float32)}}}}
    with pytest.raises(KeyError):
        from_flax_params(port, bad)


def test_dense_adam_matches_optax_step_for_step():
    """torch.optim.Adam (foreach=False) against optax.adam over 5 steps:
    same update formula, eps after the bias-corrected square root.  optax
    takes the bias correction ``1 - b2**t`` in float32, where the
    subtraction loses about 1e-5 of it; torch takes it in float64.  So one
    step's update may differ by 2e-5 of ``lr``: atol 1e-6 after 5 steps at
    lr 1e-2."""
    rng = np.random.default_rng(2)
    p0 = rng.normal(size=(50, 7)).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) for _ in range(5)]
    tx = optax.adam(1e-2)
    jp, js = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = get_optimizer("Adam", lr=1e-2)([tp])
    for g in grads:
        upd, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    with pytest.raises(KeyError):
        get_optimizer("scale_by_adam")  # an optax attribute that is no optimizer


def test_capturable_adam_matches_optax_closer(monkeypatch):
    """On the card the port's Adam is ``capturable=True`` (for its CUDA
    graphs): its step count is a float32 tensor and its bias correction
    ``1 - b**t`` is taken in float32, as optax takes it.  torch refuses CPU
    parameters there, so the test lets the CPU through torch's device check
    to run the same arithmetic.  Against optax.adam over 5 steps at lr 1e-2
    the gap falls from 2e-5 of lr a step (the test above) to one float32
    ulp of parameters below 4: atol 2.5e-7."""
    import torch.optim.adam as torch_adam

    supported = torch_adam._get_capturable_supported_devices
    monkeypatch.setattr(torch_adam, "_get_capturable_supported_devices",
                        lambda *a, **k: supported(*a, **k) + ["cpu"])
    rng = np.random.default_rng(2)
    p0 = rng.normal(size=(50, 7)).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) for _ in range(5)]
    tx = optax.adam(1e-2)
    jp, js = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.Adam([tp], lr=1e-2, betas=(0.9, 0.999), eps=1e-8, foreach=False,
                           capturable=True)
    for g in grads:
        upd, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        opt.step()
        assert opt.state[tp]["step"].dtype == torch.float32
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=0, atol=2.5e-7)
    factory = get_optimizer("Adam", lr=1e-2)
    assert factory([torch.nn.Parameter(torch.zeros(2))]).defaults["capturable"] is False


def test_sparse_route_hands_out_a_leaf_and_refuses_a_second_application():
    emb = MultiIndicesEmbedding(8, (10, 20), ("a", "b"), device="cpu")
    emb.sparse_grads = True
    batch = {"a": torch.tensor([1, 2]), "b": torch.tensor([3, 19])}
    rows = emb(batch)
    assert rows.is_leaf and rows.requires_grad and emb.embedding.grad is None
    with pytest.raises(RuntimeError, match="applied twice"):
        emb(batch)
    lookup = emb.take_lookup()
    assert lookup.rows is rows
    torch.testing.assert_close(lookup.ids, torch.tensor([[1, 13], [2, 29]]))
    assert emb.take_lookup() is None
    emb(batch)  # a new step after the lookup was taken
    with torch.no_grad():  # no autograd: the plain lookup, nothing recorded
        emb.take_lookup()
        emb(batch)
        assert emb.take_lookup() is None


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Pipeline()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiIndicesEmbedding(8, (10,), ("a",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model("DeepFM", num_fields=2, embed_size=8)
