"""Multi-head attention, the attention module's layers, the feature-axis
BatchNorm, PRM and PAL against the JAX package's, from the same flax
parameters (``convert.from_flax_params``).

* ``MultiHeadDotProductAttention`` against flax's as the JAX package calls
  it (``(x, x)``, ``qkv_features`` set, ``dtype=mha_dtype()``): float32 at
  rtol 1e-5; under bf16 (the JAX side jitted, as its Trainer runs it) at
  rtol 1e-4, which the port meets bit for bit here, since its projections
  round the product before adding the bias and its softmax rounds where
  XLA's fused one does (``layers.precision.softmax``).
* ``BiasEncodingLayer``, ``PositionEmbeddingLayer`` and
  ``PositionBiasAwareLearningFrameworkLayer`` (rtol 1e-6); ``BatchNorm``
  over the last axis against flax's ``nn.BatchNorm`` over three training
  steps (outputs and running statistics) and in eval.
* PRM in training (its running statistics held after the step) and eval
  mode, float32 (rtol 1e-5) and bf16 (atol 0.05: see the test); PAL around
  FM through nested inputs, and its ``predict``.
* One Trainer step of PRM (the dense route: its table, the encoder and the
  running statistics) after five free steps, against the JAX Trainer; the
  parameters whose gradient is 0 in exact arithmetic (``PRM_DEAD``: the
  attention's key bias; the value, out and ``ff2_<i>`` biases, before a
  BatchNorm; ``output_fc``'s bias and the last block's ``ff_bn`` bias,
  before the softmax over L) are held as gradients, at the noise, not as
  values, and so are those whose gradient is mostly cancellation
  (``SMALL_GRAD``).
* The regularizer's penalty over the MHA kernels against the JAX one."""

import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torecsys_tpu.layers as JL
import torecsys_tpu.models as JM
from torecsys_tpu import inputs as J
from torecsys_tpu import losses as JLoss
from torecsys_tpu.layers.precision import use_compute_dtype
from torecsys_tpu.train import Pipeline as JaxPipeline
from torecsys_tpu.train import Trainer as JaxTrainer
from torecsys_tpu.utils.operations import regularize as jax_regularize
from torecsys_tpu_torch import Pipeline, Trainer
from torecsys_tpu_torch import inputs as T
from torecsys_tpu_torch import layers as TL
from torecsys_tpu_torch.convert import flatten, flax_paths, from_flax_params, torch_name
from torecsys_tpu_torch.inputs.base import BaseInput
from torecsys_tpu_torch.layers.precision import apply_compute_dtype
from torecsys_tpu_torch.models import MODELS, Sequential, get_model
from torecsys_tpu_torch.train.state import batch_stats
from torecsys_tpu_torch.utils.operations import regularize

B, L, E = 4, 6, 8


def _draw(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _randomize(tree, seed, scale=0.5):
    """A flax tree as numpy, each leaf moved by N(0, scale²) draws (the
    zero biases, the ones of a scale, the 0.01 position tables)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32) + rng.normal(size=np.shape(a)) * scale).astype(
            np.float32), tree)


def _close(got, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want).astype(jnp.float32)), rtol=rtol,
                               atol=atol)


# ---- multi-head attention ----------------------------------------------------

MHA_CASES = {f"{dtype}_h{h}_d{d}": (dtype, h, d) for dtype in ("float32", "bfloat16")
             for h, d in ((1, 8), (2, 16), (4, 32))}


@pytest.mark.parametrize("case", sorted(MHA_CASES))
def test_mha_matches_flax(case):
    dtype, heads, qkv = MHA_CASES[case]
    x = _draw(B, L, E, seed=1)
    jdtype = None if dtype == "float32" else jnp.bfloat16
    jm = fnn.MultiHeadDotProductAttention(num_heads=heads, qkv_features=qkv, dropout_rate=0.0,
                                          deterministic=True, dtype=jdtype)
    params = _randomize(jm.init(jax.random.PRNGKey(0), x, x)["params"], seed=2, scale=0.1)
    want = jax.jit(lambda p, v: jm.apply({"params": p}, v, v))(params, x)
    port = from_flax_params(TL.MultiHeadDotProductAttention(E, heads, qkv_features=qkv,
                                                            device="cpu"), params)
    assert tuple(port.query.weight.shape) == (qkv // heads, heads, E)
    assert tuple(port.out.weight.shape) == (E, qkv // heads, heads)
    apply_compute_dtype(port, dtype)
    got = port(torch.from_numpy(x))
    assert got.dtype == (torch.float32 if jdtype is None else torch.bfloat16)
    assert got.shape == want.shape
    _close(got, want, rtol=1e-5 if jdtype is None else 1e-4, atol=1e-6)


def test_mha_refuses_heads_that_do_not_divide_and_drops_out_in_training():
    with pytest.raises(ValueError, match="divisible"):
        TL.MultiHeadDotProductAttention(E, 3, qkv_features=8, device="cpu")
    mha = TL.MultiHeadDotProductAttention(E, 2, dropout_rate=0.5, device="cpu")
    x = torch.from_numpy(_draw(B, L, E, seed=3))
    mha.eval()
    assert torch.equal(mha(x), mha(x))
    mha.train()
    torch.manual_seed(0)
    assert not torch.equal(mha(x), mha.eval()(x))


# ---- the attention module's layers and the feature-axis BatchNorm -------------

LAYERS = {
    "bias_encoding": (lambda: JL.BiasEncodingLayer(max_num_session=5, max_length=L, embed_size=E),
                      lambda: TL.BiasEncodingLayer(5, L, E, device="cpu"),
                      lambda: (_draw(B, L, E, seed=4), np.array([0, 4, 2, 2], np.int32))),
    "position_embedding": (lambda: JL.PositionEmbeddingLayer(max_num_position=L),
                           lambda: TL.PositionEmbeddingLayer(L, device="cpu"),
                           lambda: (_draw(B, L, E, seed=5),)),
    "pal": (lambda: JL.PALLayer(input_size=3, max_num_position=10),
            lambda: TL.PALLayer(3, 10, device="cpu"),
            lambda: (_draw(B, 3, seed=6), np.array([9, 0, 3, 3], np.int32))),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_attention_layer_matches_the_jax_layer(name):
    make_jax, make_port, make_args = LAYERS[name]
    args = make_args()
    jl = make_jax()
    params = _randomize(jl.init(jax.random.PRNGKey(0), *args)["params"], seed=7)
    port = from_flax_params(make_port(), params)
    assert set(dict(port.named_parameters())) == {torch_name(p) for p in flatten(params)}
    _close(port(*(torch.from_numpy(a) for a in args)), jl.apply({"params": params}, *args))


def test_the_layer_aliases_are_the_jax_packages():
    assert TL.MOELayer is TL.MixtureOfExpertsLayer
    assert TL.PALLayer is TL.PositionBiasAwareLearningFrameworkLayer
    assert JL.MOELayer.__name__ == TL.MOELayer.__name__
    assert JL.PALLayer.__name__ == TL.PALLayer.__name__


@pytest.mark.parametrize("shape", [(B, L, 5), (B * L, 5)])
def test_last_axis_batchnorm_tracks_flax_over_three_steps_and_in_eval(shape):
    """flax ``nn.BatchNorm`` (axis -1, PRM's): each feature's statistics over
    every other axis, three training steps with the running statistics
    carried, then eval from them."""
    jl = fnn.BatchNorm()
    x0 = _draw(*shape, seed=8, scale=2.0) + 1.0
    variables = jl.init(jax.random.PRNGKey(0), x0, use_running_average=False)
    params = _randomize(variables["params"], seed=9)
    stats = variables["batch_stats"]
    port = from_flax_params(TL.BatchNorm(shape[-1], axis=-1, device="cpu"), params)
    port.train()
    for step in range(3):
        x = _draw(*shape, seed=10 + step, scale=2.0) + 1.0
        want, mutated = jl.apply({"params": params, "batch_stats": stats}, x,
                                 use_running_average=False, mutable=["batch_stats"])
        stats = mutated["batch_stats"]
        _close(port(torch.from_numpy(x)), want, rtol=1e-5, atol=1e-5)
        _close(port.mean, stats["mean"], rtol=1e-6)
        _close(port.var, stats["var"], rtol=1e-6)
    x = _draw(*shape, seed=20)
    port.eval()
    _close(port(torch.from_numpy(x)),
           jl.apply({"params": params, "batch_stats": stats}, x, use_running_average=True),
           rtol=1e-5, atol=1e-6)


def test_batchnorm_axis_counts_from_the_end():
    with pytest.raises(ValueError, match="from the end"):
        TL.BatchNorm(4, axis=1, device="cpu")


# ---- PRM ---------------------------------------------------------------------

PRM_KWARGS = dict(encoding_size=8, num_encoder_layers=2, num_heads=2, ff_hidden_size=16)


def _prm_pair(seed=11, **kwargs):
    kwargs = {**PRM_KWARGS, **kwargs}
    jm = JM.PRM(embed_size=E, max_num_position=L, **kwargs)
    x = _draw(B, L, E, seed=seed)
    variables = jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, x,
                        training=True)
    params = _randomize(variables["params"], seed=seed + 1, scale=0.2)
    stats = _randomize(variables["batch_stats"], seed=seed + 2, scale=0.1)
    stats = jax.tree.map(np.abs, stats)  # a variance stays positive
    port = from_flax_params(get_model("PRM", embed_size=E, max_num_position=L, device="cpu",
                                      **kwargs), params, batch_stats=stats)
    return jm, port, params, stats


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prm_matches_the_jax_prm_in_training_and_eval(dtype):
    jm, port, params, stats = _prm_pair()
    apply_compute_dtype(port, dtype)
    x = _draw(B, L, E, seed=30)
    with use_compute_dtype(None if dtype == "float32" else dtype):
        train = jax.jit(lambda p, s, v: jm.apply({"params": p, "batch_stats": s}, v,
                                                training=True, mutable=["batch_stats"]))
        want, mutated = train(params, stats, x)
        want_eval = jax.jit(lambda p, s, v: jm.apply({"params": p, "batch_stats": s}, v))(
            params, mutated["batch_stats"], x)
    # bf16: the attention alone agrees to the bit (test_mha_matches_flax), but
    # jitted XLA feeds the residual sums and the biased ff2 output to the
    # float32 BatchNorm unrounded, where the port rounds each op to bf16: the
    # logits then differ by a few bf16 ulps (2^-8 of them), which the sharp
    # softmax of these randomized weights turns into up to 0.03 of a
    # probability, and the running statistics by up to 5%.  That is held
    # (probabilities within 0.05), not the bits.
    rtol, atol, stats_tol = (1e-5, 1e-6, 1e-5) if dtype == "float32" else (0.0, 5e-2, 5e-2)
    port.train()
    got = port(torch.from_numpy(x))
    assert got.shape == (B, L)
    _close(got, want, rtol=rtol, atol=atol)
    for path, value in flatten(mutated["batch_stats"]).items():
        _close(batch_stats(port)[torch_name(path)], value, rtol=stats_tol)
    from_flax_params(port, params, batch_stats=mutated["batch_stats"])
    port.eval()
    _close(port(torch.from_numpy(x)), want_eval, rtol=rtol, atol=atol)
    if dtype == "bfloat16":
        assert port.mha_0.compute_dtype == torch.bfloat16 == port.ff1_1.compute_dtype
        assert port.attn_bn_0.mean.dtype == torch.float32


def test_prm_without_position_embedding_and_the_registry():
    jm, port, params, stats = _prm_pair(seed=40, use_position_embedding=False)
    assert port.position_embedding is None
    x = _draw(B, L, E, seed=41)
    port.eval()
    _close(port(torch.from_numpy(x)), jm.apply({"params": params, "batch_stats": stats}, x),
           rtol=1e-5)
    for name in ("PRM", "PersonalizedReRanking", "PAL", "PositionBiasAwareLearningFramework"):
        assert MODELS[name].__name__ == JM.MODELS[name].__name__


# ---- PAL ---------------------------------------------------------------------

class PositionInput(BaseInput):
    """The raw ``(B,)`` position ids of one field (PAL's ``pos_inputs``)."""

    def __init__(self, field):
        super().__init__()
        self.fields = (field,)

    def forward(self, batch):
        return batch[self.fields[0]]


class JaxPositionInput(fnn.Module):
    field: str

    def __call__(self, batch, training=False):
        return batch[self.field]


N_FIELDS = 3


def _pal_inputs(port):
    if port:
        emb = T.MultiIndicesEmbedding(E, (20, 30, 10), ("a", "b", "c"), device="cpu")
        return T.Inputs({"pctr_inputs": T.Inputs({"feat_inputs": T.ValueInput(("d",)),
                                                  "emb_inputs": emb}),
                         "pos_inputs": PositionInput("pos")})
    emb = J.MultiIndicesEmbedding(embed_size=E, field_sizes=(20, 30, 10), fields=("a", "b", "c"))
    return J.Inputs(schema={"pctr_inputs": J.Inputs(schema={"feat_inputs": J.ValueInput(
        fields=("d",)), "emb_inputs": emb}), "pos_inputs": JaxPositionInput("pos")})


def _pal_batch(seed=50):
    rng = np.random.default_rng(seed)
    return {"a": rng.integers(0, 20, B).astype(np.int32),
            "b": rng.integers(0, 30, B).astype(np.int32),
            "c": rng.integers(0, 10, B).astype(np.int32),
            "d": rng.normal(size=B).astype(np.float32),
            "pos": np.array([0, 7, 3, 7], np.int32)}


def test_pal_sequential_matches_the_jax_sequential_and_predicts_the_pctr_model():
    """PAL around FM through nested inputs: its forward (the position
    branch's sigmoid) and ``predict`` (the FM alone), from the same
    parameters, the tables' included."""
    from torecsys_tpu.models import Sequential as JaxSequential

    jseq = JaxSequential(inputs=_pal_inputs(False),
                         model=JM.PAL(pctr_model=JM.FM(), max_num_position=8,
                                      pos_layer_sizes=(4,)))
    batch = _pal_batch()
    params = _randomize(jseq.init(jax.random.PRNGKey(0), batch)["params"], seed=51, scale=0.2)
    assert "pctr_model" in params["model"]
    pal = MODELS["PAL"](get_model("FM", device="cpu"), max_num_position=8, pos_layer_sizes=(4,),
                        device="cpu")
    seq = from_flax_params(Sequential(_pal_inputs(True), pal), params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _close(seq(tb), jseq.apply({"params": params}, batch), rtol=1e-5)
    pctr = seq.inputs(tb)["pctr_inputs"]
    jpctr = jseq.apply({"params": params}, batch,
                       method=lambda m, b: m.inputs(b)["pctr_inputs"])
    want = JM.PAL(pctr_model=JM.FM(), max_num_position=8, pos_layer_sizes=(4,)).apply(
        {"params": params["model"]}, jpctr, method="predict")
    _close(pal.predict(pctr), want, rtol=1e-5)
    built = MODELS["PAL"].from_inputs(_pal_inputs(True), "FM", max_num_position=8,
                                      device="cpu")
    assert type(built.pctr_model).__name__ == "FactorizationMachineModel"


# ---- the Trainer: PRM on the dense route ---------------------------------------

STEPS = 5
POSITIONS = tuple(f"p{i}" for i in range(L))
ITEMS = 40
# The parameters whose gradient is 0 in exact arithmetic: an attention's
# key bias (it moves each query's scores alike), the value and out biases
# and ff2's bias, which come right before a BatchNorm (it subtracts each
# feature's mean), output_fc's bias and the last block's ff_bn bias, which
# shift every position's logit alike before the softmax over L.
LAST_BLOCK = PRM_KWARGS["num_encoder_layers"] - 1
PRM_DEAD = re.compile(r"(^|/)(mha_\d+/(key|value|out)/bias|ff2_\d+/bias|output_fc/bias|"
                      rf"ff_bn_{LAST_BLOCK}/bias)$")
# A parameter whose gradient is under this share of the largest is mostly
# cancellation (input_fc's bias: its shift reaches the loss only through
# the first block's attention weights): Adam's scale-free step turns its
# relative rounding into a step difference of about lr times it, so it is
# held as a gradient, as the dead ones are.
SMALL_GRAD = 1e-3


def prm_batches(n, seed=60):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {p: rng.integers(0, ITEMS, B).astype(np.int32) for p in POSITIONS}
        b["label"] = (rng.uniform(size=(B, L)) < 0.3).astype(np.float32)
        out.append(b)
    return out


def _prm_pipeline(port):
    kwargs = dict(embed_size=E, max_num_position=L, **PRM_KWARGS)
    if port:
        inputs = T.Inputs({"feat_inputs": T.SingleIndexEmbedding(ITEMS, E, POSITIONS,
                                                                 device="cpu")})
        pipe = Pipeline(device="cpu")
    else:
        inputs = J.Inputs(schema={"feat_inputs": J.SingleIndexEmbedding(
            field_size=ITEMS, embed_size=E, fields=POSITIONS)})
        pipe = JaxPipeline()
    return (pipe.set_objective("ctr").set_inputs(inputs).set_model("PRM", **kwargs)
            .set_criterion("BCELoss").set_optimizer("Adam", lr=1e-2)
            .set_sparse_embeddings(False).set_target_fields("label"))


def _jax_grads(t, batch):
    """The JAX Trainer's loss gradient at its state, by flax path."""
    seq, crit = t.pipeline.sequential, t.pipeline.criterion
    features = {k: v for k, v in batch.items() if k != "label"}

    def loss(params):
        out, _ = seq.apply({"params": params, "batch_stats": t.state.batch_stats}, features,
                           training=True, mutable=["batch_stats"])
        return crit(out, batch["label"])

    return flatten(jax.device_get(jax.grad(loss)(t.state.params)))


def test_prm_trainer_step_matches_the_jax_trainer_with_its_running_statistics():
    feed = prm_batches(STEPS + 1)
    jt = JaxTrainer(_prm_pipeline(False), prefetch=0, seed=0)
    jt.init_state(feed[0])
    jt._build_steps()

    def jax_step(batch):
        with jt._trace_contexts():
            jt.state, logs = jt._train_step_fn(jt.state, jt._place_batch(batch))
        return float(logs["loss"])

    def port_trainer():
        t = Trainer(_prm_pipeline(True), prefetch=0)
        t.init_state()
        from_flax_params(t.pipeline.sequential, jax.device_get(jt.state.params),
                         batch_stats=jax.device_get(jt.state.batch_stats))
        return t

    port = port_trainer()
    assert port.sparse is False
    want = [jax_step(b) for b in feed[:STEPS]]
    got = [float(x) for x in port.train_steps(feed[:STEPS])]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # one step from the JAX Trainer's state
    port = port_trainer()
    from_flax_params(port.pipeline.sequential, jax.device_get(jt.state.params),
                     jax.device_get(jt.state.opt_state), port.state, step=int(jt.state.step))
    last = feed[STEPS]
    seq = port.pipeline.sequential
    seq.train()
    tb = {k: torch.from_numpy(v) for k, v in last.items()}
    label = tb.pop("label")
    snap = {n: b.clone() for n, b in batch_stats(seq).items()}
    loss = port.pipeline.criterion(seq(tb), label)
    grads = dict(zip(dict(seq.named_parameters()), torch.autograd.grad(loss, list(
        seq.parameters()))))
    with torch.no_grad():
        for n, b in batch_stats(seq).items():
            b.copy_(snap[n])
    jgrads = _jax_grads(jt, last)
    largest = max(float(np.abs(g).max()) for g in jgrads.values())
    by_gradient = set()
    for path, jg in jgrads.items():
        g = grads[torch_name(path)].numpy()
        jg = np.asarray(jg)
        jg = jg.T if path.endswith("kernel") else jg
        if PRM_DEAD.search(path):
            by_gradient.add(path)
            assert np.abs(g).max() <= 1e-6 * largest and np.abs(jg).max() <= 1e-6 * largest, path
            continue
        np.testing.assert_allclose(g, jg, rtol=1e-3, atol=1e-6 * largest, err_msg=path)
        if np.abs(jg).max() < SMALL_GRAD * largest:
            by_gradient.add(path)
    dead = sum(bool(PRM_DEAD.search(p)) for p in by_gradient)
    assert dead == 4 * PRM_KWARGS["num_encoder_layers"] + 2
    np.testing.assert_allclose(float(port.train_steps([last])[0]), jax_step(last), rtol=1e-5)
    named = dict(seq.named_parameters())
    for path, ref in flatten(jax.device_get(jt.state.params)).items():
        if path in by_gradient:
            continue
        ref = np.asarray(ref)
        np.testing.assert_allclose(named[torch_name(path)].detach().numpy(),
                                   ref.T if path.endswith("kernel") else ref, rtol=0, atol=1e-6,
                                   err_msg=path)
    assert len(by_gradient) < len(named) // 2
    for path, ref in flatten(jax.device_get(jt.state.batch_stats)).items():
        np.testing.assert_allclose(batch_stats(seq)[torch_name(path)].numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6, err_msg=path)


# ---- the regularizer over the attention's kernels -------------------------------

def test_regularizer_selects_the_mha_kernels_by_flax_path():
    """``key_filter="kernel"`` takes the MHA's query, key, value and out
    kernels (three-dimensional in flax) and the Dense kernels, as in the
    JAX package; ``"query"`` takes the query's kernel and bias."""
    _, port, params, _ = _prm_pair(seed=70)
    paths = flax_paths(port)
    assert paths["mha_0.query.weight"] == "mha_0/query/kernel"
    assert paths["mha_1.out.weight"] == "mha_1/out/kernel"
    for key_filter in ("kernel", "bias", "query", "embedding"):
        want = float(jax_regularize(params, weight_decay=0.01, norm=2, key_filter=key_filter))
        got = float(regularize(port.requires_grad_(False), weight_decay=0.01, norm=2,
                               key_filter=key_filter))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12)
