"""bf16 compute and bf16 tables (``layers/precision.py``,
``Pipeline.set_compute_dtype`` and ``set_table_dtype``) against the JAX
package from the same weights, and ``row_gather``'s plain twin and the
lookup's backward on a bf16 table."""

import jax
import numpy as np
import pytest
import torch
from test_torch_train import FIELDS, LR, TOWER, _batches, _schema

from torecsys_tpu import inputs as jax_inputs
from torecsys_tpu.train import Pipeline as JaxPipeline
from torecsys_tpu.train import Trainer as JaxTrainer
from torecsys_tpu_torch import Pipeline, Trainer
from torecsys_tpu_torch.convert import flatten, from_flax_params, torch_name
from torecsys_tpu_torch.ops.embedding import table_grad
from torecsys_tpu_torch.ops.kernels import embedding as KE

TABLE = "inputs/schema_emb_inputs/embedding"


def _jax(batches, compute=None, table=None, sparse=None):
    pipe = (JaxPipeline().set_objective("ctr").set_inputs(_schema(jax_inputs))
            .set_model("DeepFM", deep_layer_sizes=TOWER).set_criterion("BCEWithLogitsLoss")
            .set_optimizer("Adam", lr=LR).set_sparse_embeddings(sparse)
            .set_target_fields("label").set_compute_dtype(compute).set_table_dtype(table))
    t = JaxTrainer(pipe, prefetch=0, seed=0)
    t.init_state(batches[0])
    t._setup_presorter()
    t._build_steps()
    return t


def _jax_step(t, batch):
    if t._presorter is not None:
        batch = t._presorter(batch)
    with t._trace_contexts():
        t.state, logs = t._train_step_fn(t.state, t._place_batch(batch))
    return float(logs["loss"])


def _port(params, compute=None, table=None, sparse=None):
    pipe = (Pipeline(device="cpu").set_objective("ctr").set_inputs(_schema(None))
            .set_model("DeepFM", deep_layer_sizes=TOWER).set_criterion("BCEWithLogitsLoss")
            .set_optimizer("Adam", lr=LR).set_sparse_embeddings(sparse)
            .set_target_fields("label").set_compute_dtype(compute).set_table_dtype(table))
    trainer = Trainer(pipe, prefetch=0)
    trainer.init_state()
    from_flax_params(pipe.sequential, params, None, trainer.state)
    return trainer


def test_bf16_forward_matches_the_jax_package():
    """The tower's products in bf16 from the same weights: the scores equal
    the JAX package's under ``set_compute_dtype("bfloat16")`` (atol 1e-6 on
    probabilities; both cast input, weight and bias to bf16 and add the
    float32 FM part after), and differ from float32 compute."""
    batches = _batches()
    ref = _jax(batches, compute="bfloat16")
    port = _port(jax.device_get(ref.state.params), compute="bfloat16")
    mlp = port.pipeline.sequential.model.deep
    assert all(mlp.get_submodule(n).compute_dtype == torch.bfloat16
               for n in (*mlp.hidden, "output"))
    for batch in batches[:2]:
        with ref._eval_contexts():
            want = np.asarray(ref._eval_step_fn(ref.state, jax.device_put(batch))[0])
        got = port.predict(batch)
        assert got.dtype == torch.float32
        # not to the bit: after the bf16 tower the float32 FM part and the
        # float32 sigmoid are XLA's on one side and torch's on the other, and
        # part by a float32 ulp (about 1 probability in 256)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    f32 = _port(jax.device_get(ref.state.params))
    assert not torch.equal(f32.predict(batches[0]), port.predict(batches[0]))


def test_bf16_compute_trains_with_float32_parameters():
    """tests/test_trainer.py:229: three sparse steps under bf16 compute track
    the JAX Trainer's (losses rtol 1e-5); every parameter stays float32 and
    predict returns float32."""
    batches = _batches()[:3]
    ref = _jax(batches, compute="bfloat16", sparse=True)
    port = _port(jax.device_get(ref.state.params), compute="bfloat16", sparse=True)
    ref_losses = [_jax_step(ref, b) for b in batches]
    losses = [float(x) for x in port.train_steps(batches)]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert all(p.dtype == torch.float32 for p in port.pipeline.sequential.parameters())
    assert port.predict(batches[0]).dtype == torch.float32


def test_bf16_table_dense_step_matches_the_jax_package():
    """tests/test_trainer.py:255: a bf16 table stays on the dense route
    under the automatic choice, stores bf16 with bf16 Adam moments, and one
    step from the same weights tracks the JAX Trainer's: the loss (rtol
    1e-5) and the tower (atol 1e-6).  The table gradient is summed in
    float32 and rounded once (``ops.embedding.table_grad``), where the JAX
    package adds in bf16.  A row touched once gets the same gradient, and
    its elements differ only by the two Adams' bf16 roundings: within one
    bf16 ulp of the element and two of lr.  A row touched more often may
    see its gradient's sign change where the sum nearly cancels, and Adam's
    first step moves an element by about lr either way, so every element
    lies within 2 * lr + one ulp."""
    batches = _batches()
    ref = _jax(batches, table="bfloat16")
    port = _port(jax.device_get(ref.state.params), table="bfloat16")
    table = port.pipeline.sequential.inputs.schema["emb_inputs"].embedding
    assert port.sparse is False and port._presorter is None
    assert table.dtype == torch.bfloat16
    np.testing.assert_allclose(float(port.train_steps(batches[:1])[0]),
                               _jax_step(ref, batches[0]), rtol=1e-5)
    assert port.state.opt_state.state[table]["exp_avg"].dtype == torch.bfloat16
    params = jax.device_get(ref.state.params)
    named = dict(port.pipeline.sequential.named_parameters())
    for path, value in flatten(params).items():
        got = named[torch_name(path)].detach().float().numpy()
        want = np.asarray(value).astype(np.float32)
        if path == TABLE:
            continue
        np.testing.assert_allclose(got, want.T if path.endswith("kernel") else want,
                                   rtol=0, atol=1e-6, err_msg=path)
    got = table.detach().float().numpy().reshape(-1, 16)[:sum(FIELDS)]
    want = np.asarray(params["inputs"]["schema_emb_inputs"]["embedding"]).astype(
        np.float32).reshape(-1, 16)[:sum(FIELDS)]
    ulp = np.spacing(np.abs(want)) * 2.0**16  # float32 spacing, widened to bf16's
    assert np.all(np.abs(got - want) <= 2 * LR + ulp)
    ids = np.stack([batches[0][f"cat_{i}"] + off for i, off in
                    enumerate(np.concatenate([[0], np.cumsum(FIELDS)[:-1]]))], 1).reshape(-1)
    once = np.bincount(ids, minlength=sum(FIELDS)) == 1
    assert once.sum() > 100
    ulp_lr = np.spacing(np.float32(LR)) * 2.0**16
    assert np.all(np.abs(got - want)[once] <= ulp[once] + 2 * ulp_lr)


def test_bf16_table_refuses_the_sparse_route():
    with pytest.raises(ValueError, match="dense embedding path"):
        _port(None, table="bfloat16", sparse=True)
    with pytest.raises(ValueError, match="unsupported dtype"):
        Pipeline(device="cpu").set_compute_dtype("float16")


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
def test_row_gather_plain_twin_on_a_bf16_table(ids_dtype):
    """Bit-identical to ``index_select`` on the rows in range; an id outside
    ``[-rows, rows)`` gets bf16's NaN bits (0x7fc0), which the kernel
    writes."""
    gen = torch.Generator().manual_seed(0)
    src = torch.randn(1001, 16, generator=gen).to(torch.bfloat16)
    idx = torch.randint(-1001, 1001, (4096,), generator=gen).to(ids_dtype)
    got = KE.row_gather(src, idx)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), src.index_select(0, idx.long() % 1001).view(
        torch.int16))
    bad = KE.row_gather(src, torch.tensor([1001, -1002], dtype=ids_dtype))
    assert (bad.view(torch.int16) == 0x7FC0).all()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        KE.row_gather(src.half(), idx)


def test_lookup_backward_of_a_bf16_table_sums_in_float32():
    """``table_grad`` of a bf16 cotangent: the float32 ``index_add_`` sum
    rounded once to bf16, bit for bit."""
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 500, (3000,), generator=gen)
    grad = torch.randn(3000, 16, generator=gen).to(torch.bfloat16)
    got = table_grad(ids, grad, (63, 128), torch.bfloat16)
    want = torch.zeros(504, 16).index_add_(0, ids, grad.float()).reshape(63, 128)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.to(torch.bfloat16).view(torch.int16))
