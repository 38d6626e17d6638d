"""The single-device API remainder against the JAX package: the two lookups,
``strip_aux``, ``TqdmHandler``, ``not_jittable``, ``use_torch_linear_init``
and the two examples.

* ``embedding_lookup`` and ``fused_offset_lookup`` against ``jnp.take``
  (bit for bit: gathers), ids in range, negative ids (wrapped, both
  sides) and ids past the table (NaN rows, both sides), and their
  gradients against ``jax.grad`` (an id past the table adds nothing).
* ``strip_aux`` on a presorted batch, as the JAX one strips it.
* ``TqdmHandler``: records through ``tqdm.write`` and, without ``tqdm``, to
  stderr; a failing format goes to ``handleError`` and never raises.
* ``not_jittable``: a call passes through, and under a (patched) capture it
  raises before the wrapped function runs.
* ``use_torch_linear_init``: inside it the pipeline-following ``Dense``
  draws ``U(+-1/sqrt(fan_in))`` for weight and bias (the bounds and the
  moments, as the JAX twin draws them), names and shapes as flax's, and
  flax's init returns when the context exits.
* The two examples, ``python -m`` on the CPU at one epoch each.
* ``chip_smoke.held_compare`` with Adam's sensitivity (the held steps'
  tolerance on the card) on a first Adam step whose gradient sum cancels.
* ``chip_smoke.abs_sums`` and ``adam_sensitivity`` on a step with two
  history tables of one size (the held mixed path's): each table gets its
  own sums, its own gradient, and its own sensitivity.
"""

import builtins
import logging
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torecsys_tpu.data.presort import Presorter as JaxPresorter
from torecsys_tpu.data.presort import build_presort_specs as jax_specs
from torecsys_tpu.data.presort import strip_aux as jax_strip_aux
from torecsys_tpu.layers import precision as jax_precision
from torecsys_tpu.ops.embedding import embedding_lookup as jax_lookup
from torecsys_tpu.ops.embedding import fused_offset_lookup as jax_offset_lookup
from torecsys_tpu.utils.logging import TqdmHandler as JaxTqdmHandler
from torecsys_tpu_torch.data.presort import strip_aux
from torecsys_tpu_torch.layers.ctr.dense import Dense
from torecsys_tpu_torch.layers.precision import torch_linear_init, use_torch_linear_init
from torecsys_tpu_torch.ops.embedding import embedding_lookup, field_offsets, fused_offset_lookup
from torecsys_tpu_torch.utils import decorator
from torecsys_tpu_torch.utils.logging import TqdmHandler

V, E = 11, 4


def table(seed=0):
    return np.random.default_rng(seed).normal(size=(V, E)).astype(np.float32)


@pytest.mark.parametrize("ids", [[[0, 3, 10], [5, 5, 1]], [[-1, -11, 2]], [[11, 40, 0]],
                                 [[-12, 3, -5]]],
                         ids=["in-range", "negative", "past-the-end", "past-the-front"])
def test_embedding_lookup_and_its_gradient_match_jnp_take(ids):
    """``jnp.take``'s default mode: negative ids in ``[-V, 0)`` wrap, other
    ids outside ``[-V, V)`` read NaN rows and get no gradient, on both sides."""
    t, idx = table(), np.asarray(ids, np.int32)
    want = np.asarray(jax_lookup(jnp.asarray(t), jnp.asarray(idx)))
    tt = torch.from_numpy(t).requires_grad_()
    got = embedding_lookup(tt, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    cot = np.random.default_rng(1).normal(size=want.shape).astype(np.float32)
    grad = jax.grad(lambda x: jnp.nansum(jax_lookup(x, jnp.asarray(idx)) * cot))(jnp.asarray(t))
    (got.nan_to_num() * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(grad), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("offsets", [None, "fields"])
def test_fused_offset_lookup_matches_the_jax_package(offsets):
    sizes = (3, 5, 3)
    offs = field_offsets(sizes) if offsets else None
    idx = np.array([[0, 4, 2], [2, 0, 1]], np.int32)
    t = table(2)
    want = np.asarray(jax_offset_lookup(jnp.asarray(t), jnp.asarray(idx), offs))
    got = fused_offset_lookup(torch.from_numpy(t), torch.from_numpy(idx), offs)
    assert got.shape == (2, 3, E)
    np.testing.assert_array_equal(got.numpy(), want)


def test_strip_aux_matches_the_jax_package():
    from torecsys_tpu import inputs as J
    from torecsys_tpu.models import Sequential  # noqa: F401 - the JAX package's registry

    emb = J.MultiIndicesEmbedding(embed_size=4, field_sizes=(9, 7), fields=("a", "b"))
    specs = jax_specs(J.Inputs(schema={"emb_inputs": emb}))
    rng = np.random.default_rng(0)
    batch = {"a": rng.integers(0, 9, 16).astype(np.int32),
             "b": rng.integers(0, 7, 16).astype(np.int32),
             "label": rng.uniform(size=16).astype(np.float32)}
    presorted = JaxPresorter(specs)(batch)
    assert len(presorted) > len(batch)
    want, got = jax_strip_aux(presorted), strip_aux(presorted)
    assert list(got) == list(want) == list(batch)
    assert all(got[k] is want[k] for k in got)


def test_tqdm_handler_writes_through_tqdm_and_never_raises(capsys, monkeypatch):
    pytest.importorskip("tqdm")
    for cls in (TqdmHandler, JaxTqdmHandler):
        logger = logging.getLogger(f"tqdm-test-{cls.__module__}")
        logger.propagate = False
        handler = cls()
        handler.setFormatter(logging.Formatter("%(levelname)s %(message)s"))
        logger.addHandler(handler)
        logger.warning("through tqdm")
        assert capsys.readouterr().err == "WARNING through tqdm\n"
        # a record whose message cannot be formatted goes to handleError
        handled = []
        monkeypatch.setattr(handler, "handleError", handled.append)
        logger.warning("%d", "not a number")
        assert len(handled) == 1
        logger.removeHandler(handler)


def test_tqdm_handler_falls_back_to_stderr_without_tqdm(capsys, monkeypatch):
    real_import = builtins.__import__

    def no_tqdm(name, *args, **kwargs):
        if name == "tqdm":
            raise ImportError("no tqdm")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tqdm)
    handler = TqdmHandler()
    handler.emit(logging.LogRecord("x", logging.INFO, __file__, 1, "plain %s", ("line",), None))
    assert capsys.readouterr().err == "plain line\n"


def test_not_jittable_passes_through_and_refuses_under_a_capture(monkeypatch):
    calls = []

    @decorator.not_jittable
    def grow(x):
        calls.append(x)
        return x + 1

    assert grow(1) == 2 and calls == [1] and grow.__name__ == "grow"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="grow is host-side only.*CUDA graph capture"):
        grow(5)
    assert calls == [1]  # nothing of the call ran
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    assert grow(7) == 8


def test_the_jax_not_jittable_refuses_under_a_trace():
    """The reference's meaning, which the port's capture refusal mirrors."""
    from torecsys_tpu.utils.decorator import not_jittable

    f = not_jittable(lambda x: x + 1)
    assert f(1) == 2
    with pytest.raises(RuntimeError, match="host-side only"):
        jax.jit(f)(jnp.int32(1))


def test_use_torch_linear_init_draws_torch_linears_init():
    fan_in, out = 256, 512
    bound = fan_in ** -0.5
    with jax_precision.use_torch_linear_init():
        jd = jax_precision.Dense(out)
        jv = jax.device_get(jd.init(jax.random.PRNGKey(0), jnp.ones((1, fan_in)))["params"])
    assert torch_linear_init() is False
    with use_torch_linear_init():
        assert torch_linear_init() is True
        port = Dense(fan_in, out, device="cpu")
        plain = Dense(fan_in, out, follows_pipeline=False, device="cpu")
    assert torch_linear_init() is False
    assert tuple(port.weight.shape) == jv["kernel"].shape[::-1]
    assert tuple(port.bias.shape) == jv["bias"].shape
    for ours, theirs in ((port.weight.detach().numpy(), jv["kernel"]),
                         (port.bias.detach().numpy(), jv["bias"])):
        for x in (ours, theirs):
            assert np.abs(x).max() <= bound and np.abs(x).max() > 0.95 * bound
            # U(-b, b): mean 0, variance b^2 / 3
            n = x.size
            assert abs(x.mean()) < 4 * bound / np.sqrt(3 * n)
            np.testing.assert_allclose(x.var(), bound ** 2 / 3, rtol=8 / np.sqrt(n))
    # a plain flax site (follows_pipeline=False) keeps flax's init, as does
    # a Dense built after the context: lecun-normal weight, zero bias
    after = Dense(fan_in, out, device="cpu")
    for d in (plain, after):
        assert not d.bias.detach().any()
        np.testing.assert_allclose(d.weight.detach().numpy().std(), fan_in ** -0.5, rtol=0.05)


@pytest.mark.parametrize("module,key", [("train_fm_sample", "val AUC"),
                                        ("ltr_with_miner", "NDCG@10")])
def test_examples_run_on_the_cpu(module, key):
    proc = subprocess.run([sys.executable, "-m", f"torecsys_tpu_torch.examples.{module}",
                           "--device", "cpu", "--epochs", "1"], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert key in proc.stdout
    value = float(proc.stdout.split(key)[-1].split()[-1 if key == "NDCG@10" else 0].strip(":"))
    assert 0.0 < value <= 1.0


def test_held_compare_bounds_adams_first_step_by_its_sensitivity():
    """``chip_smoke.held_compare``'s tolerance with Adam's sensitivity: from
    fresh moments an element whose summed gradient nearly cancels to near
    eps moves by ``lr g / (|g| + eps)``, so the last bits of two summation
    orders move its step by far more than the older tolerance (2 ulps + 1e-3
    of the largest change); with the sensitivity of the summation-order
    bound it passes, a step that wrote nothing still fails, and where |g|
    is far above eps the tolerance is the older one."""
    import chip_smoke as cs

    lr, b1, b2, eps = 1e-3, 0.9, 0.999, 1e-8
    g_plain = torch.tensor([8e-10, 3e-4, -2e-3], dtype=torch.float32)
    abs_sum = torch.tensor([3e-4, 3e-4, 2e-3])
    n = torch.tensor([800.0, 3.0, 1.0])
    d = 2 * (n - 1).clamp_min(1) * cs.SUM_UNIT * abs_sum
    g_kernel = g_plain + torch.tensor([0.5, 0.0, 0.0]) * d  # another summation order

    def step(g):
        return -lr * g / (g.abs() + eps)  # Adam's first step from fresh moments

    start = torch.zeros(3)
    x, dd = g_plain.double(), d.double()
    sens = torch.maximum((step(x + dd) - step(x)).abs(), (step(x - dd) - step(x)).abs())
    plain, kernel = start + step(g_plain), start + step(g_kernel)
    worst_new, _, _, worst_old = cs.held_compare(start, plain, kernel, sens.float())
    assert worst_old > 1.0 >= worst_new
    noop, _, _, _ = cs.held_compare(start, plain, start.clone(), sens.float())
    assert noop > 100
    # far above eps the sensitivity is far under 1e-3 of the largest change
    assert (sens[1:] < 1e-3 * (plain - start).abs().max()).all()


def test_abs_sums_keep_each_table_of_one_size_apart():
    """The held mixed path's tables at a small size: a bench table on the
    row route and two history tables of one size on the dense optimizer
    through ``table_grad``, both over one Zipf stream, so their hot ids
    coincide.  ``abs_sums`` keeps one entry for each table: each history
    table's summed gradient is that table's own, bit for bit, and its term
    count is its own lookups; ``adam_sensitivity`` gives each table its
    own bound."""
    import chip_smoke as cs
    from torecsys_tpu_torch import Inputs, Pipeline, ValueInput
    from torecsys_tpu_torch.inputs import (ListIndicesEmbedding, MultiIndicesEmbedding,
                                           SequenceIndicesEmbedding, StackedInput)
    from torecsys_tpu_torch.train import Trainer

    vocab, e, b, length, sizes = 40, 4, 16, 5, (30, 20)
    stacked = StackedInput([
        MultiIndicesEmbedding(e, sizes, ("cat_0", "cat_1"), device="cpu"),
        SequenceIndicesEmbedding(vocab, e, ("behaviour",), lengths_field="behaviour_len",
                                 rnn_method="lstm", output_method="avg_pooling", device="cpu"),
        ListIndicesEmbedding(vocab, e, ("clicks",), use_attn=True, num_heads=2, device="cpu")])
    pipeline = (Pipeline(device="cpu").set_objective("ctr")
                .set_inputs(Inputs({"feat_inputs": ValueInput(("dense_0",)),
                                    "emb_inputs": stacked}))
                .set_model("DeepFM", deep_layer_sizes=(8,)).set_criterion("BCEWithLogitsLoss")
                .set_optimizer("Adam", lr=1e-3).set_sparse_embeddings(True)
                .set_target_fields("label"))
    rng = np.random.default_rng(0)
    batch = {f"cat_{i}": rng.integers(0, v, b).astype(np.int32) for i, v in enumerate(sizes)}
    batch["dense_0"] = rng.normal(size=b).astype(np.float32)
    batch["label"] = (rng.uniform(size=b) < 0.5).astype(np.float32)
    for field in ("behaviour", "clicks"):
        batch[field] = np.minimum(rng.zipf(1.2, size=(b, length)), vocab - 1).astype(np.int32)
        batch[f"{field}_len"] = rng.integers(1, length + 1, b).astype(np.int32)
    trainer = Trainer(pipeline, log_every=10**9)
    trainer.train_steps([batch])  # Adam's moments exist, so adam_rule reads them
    start = cs.dense_state(trainer)
    with cs.abs_sums() as sums:
        trainer.train_steps([batch])
    tables = cs.embedding_tables(trainer)
    assert sorted(sums) == sorted(m.embedding.data_ptr() for m in tables.values())
    history = {n: m for n, m in tables.items() if isinstance(
        m, (SequenceIndicesEmbedding, ListIndicesEmbedding))}
    assert len(history) == 2
    for module in history.values():
        g, a, n = sums[module.embedding.data_ptr()]
        np.testing.assert_array_equal(g.reshape(-1).numpy(),
                                      module.embedding.grad.reshape(-1).numpy())
        assert (a >= g.abs()).all()
        assert n.sum().item() == b * length * e  # every id of its own field, E elements each
    sensitivity = cs.adam_sensitivity(trainer, start, sums)
    assert set(history) <= set(sensitivity)
    first, second = (sensitivity[name] for name in history)
    assert not torch.equal(first, second)
