"""The port's CTR layers and the nine models this slice adds against the JAX
package's, from the same flax parameters (and ``batch_stats``) carried over
by ``convert.from_flax_params``.

Every parameter that flax initializes to a constant (biases, a BatchNorm's
scale and bias) is moved by a numpy draw before the carry-over, so that no
layer is compared at a trivial initialization; the kernels keep flax's
draws.  The CIN's biases before its BatchNorm stay 0: a batch norm cancels
a per-channel bias in its output, and a random one makes flax's fast
variance ``E[x²] − E[x]²`` cancel catastrophically, so that the two sides'
rounding differs by 1.2e-5 in the output (with them at 0: under 2e-6).
Layers: float32, rtol 1e-6 / atol 1e-6.  Models: rtol
1e-5, in training and in eval mode, on the shapes of ``tests/test_models.py``.
The CIN's BatchNorm follows flax's arithmetic: its statistics and outputs
after 3 training steps are held to flax's, and its running variance to the
biased update."""

import jax
import numpy as np
import pytest
import torch

import torecsys_tpu.layers as JL
import torecsys_tpu.models as JM
from torecsys_tpu.models.base import MODELS as JAX_MODELS
from torecsys_tpu_torch import layers as TL
from torecsys_tpu_torch.convert import from_flax_params
from torecsys_tpu_torch.models import MODELS, get_model

B, N, E = 4, 5, 8


CIN_BIASES = ("bias_0", "bias_1")


def _randomize(tree, seed, keep=()):
    """A flax tree as numpy, each leaf that holds one constant (a zeros or
    ones init) moved by N(0, 0.5²) draws, but the leaves named in ``keep``."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        a = np.asarray(a, dtype=np.float32)
        if path[-1].key in keep or a.size == 0 or not np.all(a == a.flat[0]):
            return a
        return (a + rng.normal(size=a.shape) * 0.5).astype(np.float32)

    return jax.tree_util.tree_map_with_path(move, tree)


def _draw(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _port(module, params, batch_stats=None):
    return from_flax_params(module, params, batch_stats=batch_stats)


def _close(got, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, dtype=np.float32),
                               rtol=rtol, atol=atol)


# ---- layers -------------------------------------------------------------------

LAYERS = {
    "wide": (lambda: JL.WideLayer(output_size=3),
             lambda: TL.WideLayer(N * E, 3, device="cpu"), lambda: (_draw(B, N * E),)),
    "ffm": (lambda: JL.FieldAwareFactorizationMachineLayer(num_fields=N),
            lambda: TL.FieldAwareFactorizationMachineLayer(N), lambda: (_draw(B, N * N, E),)),
    "inner": (lambda: JL.InnerProductNetworkLayer(), lambda: TL.InnerProductNetworkLayer(),
              lambda: (_draw(B, N, E),)),
    "outer_mat": (lambda: JL.OuterProductNetworkLayer(num_fields=N, embed_size=E),
                  lambda: TL.OuterProductNetworkLayer(N, E, device="cpu"),
                  lambda: (_draw(B, N, E),)),
    "outer_vec": (lambda: JL.OuterProductNetworkLayer(num_fields=N, embed_size=E,
                                                      kernel_type="vec"),
                  lambda: TL.OuterProductNetworkLayer(N, E, "vec", device="cpu"),
                  lambda: (_draw(B, N, E),)),
    "outer_num": (lambda: JL.OuterProductNetworkLayer(num_fields=N, embed_size=E,
                                                      kernel_type="num"),
                  lambda: TL.OuterProductNetworkLayer(N, E, "num", device="cpu"),
                  lambda: (_draw(B, N, E),)),
    "cross": (lambda: JL.CrossNetworkLayer(num_layers=3),
              lambda: TL.CrossNetworkLayer(3, N * E, device="cpu"), lambda: (_draw(B, N, E),)),
    "cin_direct_nobn": (lambda: JL.CompressInteractionNetworkLayer(
        embed_size=E, num_fields=N, output_size=2, layer_sizes=(6, 4), is_direct=True,
        use_batchnorm=False),
        lambda: TL.CompressInteractionNetworkLayer(E, N, 2, (6, 4), is_direct=True,
                                                   use_batchnorm=False, device="cpu"),
        lambda: (_draw(B, N, E),)),
    "gmf": (lambda: JL.GeneralizedMatrixFactorizationLayer(),
            lambda: TL.GeneralizedMatrixFactorizationLayer(), lambda: (_draw(B, 2, E),)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_the_jax_layer(name):
    make_jax, make_port, make_inputs = LAYERS[name]
    args = make_inputs()
    jl = make_jax()
    params = _randomize(jl.init(jax.random.PRNGKey(0), *args).get("params", {}), seed=1,
                        keep=CIN_BIASES)
    want = jl.apply({"params": params}, *args)
    port = _port(make_port(), params)
    _close(port(*(torch.from_numpy(a) for a in args)), want)


def test_afm_layer_returns_the_pooled_interaction_and_the_scores():
    x = _draw(B, N, E)
    jl = JL.AttentionalFactorizationMachineLayer(embed_size=E, attn_size=4)
    params = _randomize(jl.init(jax.random.PRNGKey(0), x)["params"], seed=2)
    want_out, want_attn = jl.apply({"params": params}, x)
    port = _port(TL.AttentionalFactorizationMachineLayer(E, 4, device="cpu"), params)
    out, attn = port(torch.from_numpy(x))
    assert attn.shape == (B, N * (N - 1) // 2, 1)
    _close(out, want_out)
    _close(attn, want_attn)


def test_pnn_outer_kernel_is_flaxs_kernel_transposed():
    layer = TL.OuterProductNetworkLayer(N, E, device="cpu")
    p = N * (N - 1) // 2
    assert tuple(layer.weight.shape) == (E, p, E) and tuple(layer.kernel.shape) == (E, p, E)
    k = _draw(E, p, E)
    from_flax_params(layer, {"kernel": k})
    np.testing.assert_array_equal(layer.kernel.detach().numpy(), k)
    np.testing.assert_array_equal(layer.weight.detach().numpy(), k.T)


# ---- the CIN's BatchNorm --------------------------------------------------------

def _cin_pair(is_direct):
    jl = JL.CompressInteractionNetworkLayer(embed_size=E, num_fields=N, output_size=1,
                                            layer_sizes=(6, 4), is_direct=is_direct)
    variables = jl.init(jax.random.PRNGKey(0), _draw(B, N, E))
    params = _randomize(variables["params"], seed=3, keep=CIN_BIASES)
    port = TL.CompressInteractionNetworkLayer(E, N, 1, (6, 4), is_direct=is_direct,
                                              device="cpu")
    return jl, params, variables["batch_stats"], _port(port, params)


@pytest.mark.parametrize("is_direct", [False, True])
def test_cin_batchnorm_tracks_flax_over_three_steps_and_in_eval(is_direct):
    jl, params, stats, port = _cin_pair(is_direct)
    port.train()
    for step in range(3):
        x = _draw(B, N, E, seed=10 + step) * (1 + step)
        want, mutated = jl.apply({"params": params, "batch_stats": stats}, x, training=True,
                                 mutable=["batch_stats"])
        stats = mutated["batch_stats"]
        _close(port(torch.from_numpy(x)), want)
        for k in range(2):
            for name in ("mean", "var"):
                _close(getattr(getattr(port, f"bn_{k}"), name), stats[f"bn_{k}"][name])
    x = _draw(B, N, E, seed=20)
    port.eval()
    _close(port(torch.from_numpy(x)), jl.apply({"params": params, "batch_stats": stats}, x))


def test_batchnorm_running_variance_is_the_biased_one_at_flax_momentum():
    """flax: ra = 0.99 ra + 0.01 var, var = E[x²] - E[x]² over (B, E), biased.
    An unbiased update (torch's BatchNorm1d) moves the running variance by
    0.01 * var / (B*E - 1) more, 1.6e-4 here: the bound is 1e-6."""
    bn = TL.BatchNorm(3, device="cpu")
    x = _draw(B, 3, E, seed=4) * 2 + 1
    bn.train()
    bn(torch.from_numpy(x))
    xd = x.astype(np.float64)
    var = xd.var(axis=(0, 2))  # biased
    unbiased = xd.var(axis=(0, 2), ddof=1)
    np.testing.assert_allclose(bn.var.numpy(), 0.99 + 0.01 * var, rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.mean.numpy(), 0.01 * xd.mean(axis=(0, 2)), rtol=0, atol=1e-6)
    assert np.abs(bn.var.numpy() - (0.99 + 0.01 * unbiased)).min() > 1e-5
    assert bn.mean.dtype == torch.float32 and bn.var.dtype == torch.float32
    assert {n for n, _ in bn.named_buffers()} == {"mean", "var"}


# ---- the nine models ---------------------------------------------------------------

def _feat():
    return _draw(B, N, 1, seed=5)


def _emb():
    return _draw(B, N, E, seed=6)


MODEL_CASES = {
    # name: (JAX model, port kwargs, inputs as (JAX positional, port keyword names))
    "FMNN": (lambda: JM.FMNN(deep_layer_sizes=(8,)),
             dict(feat_size=N, embed_size=E, deep_layer_sizes=(8,)),
             lambda: [("feat_inputs", _feat()), ("emb_inputs", _emb())]),
    "FFM": (lambda: JM.FFM(num_fields=N), dict(num_fields=N),
            lambda: [("feat_inputs", _feat()),
                     ("field_emb_inputs", _draw(B, N * N, E, seed=7))]),
    "AFM": (lambda: JM.AFM(embed_size=E, attn_size=4), dict(embed_size=E, attn_size=4),
            lambda: [("feat_inputs", _feat()), ("emb_inputs", _emb())]),
    "NFM": (lambda: JM.NFM(deep_layer_sizes=(8,)), dict(embed_size=E, deep_layer_sizes=(8,)),
            lambda: [("feat_inputs", _feat()), ("emb_inputs", _emb())]),
    "PNN": (lambda: JM.PNN(num_fields=N, embed_size=E, deep_layer_sizes=(8,)),
            dict(feat_size=N, num_fields=N, embed_size=E, deep_layer_sizes=(8,)),
            lambda: [("feat_inputs", _feat()), ("emb_inputs", _emb())]),
    "PNN_outer": (lambda: JM.PNN(num_fields=N, embed_size=E, deep_layer_sizes=(8,),
                                 prod_method="outer"),
                  dict(feat_size=N, num_fields=N, embed_size=E, deep_layer_sizes=(8,),
                       prod_method="outer"),
                  lambda: [("feat_inputs", _feat()), ("emb_inputs", _emb())]),
    "DCN": (lambda: JM.DCN(cross_num_layers=2, deep_output_size=4, deep_layer_sizes=(8,)),
            dict(num_fields=N, embed_size=E, cross_num_layers=2, deep_output_size=4,
                 deep_layer_sizes=(8,)),
            lambda: [("emb_inputs", _emb())]),
    "xDeepFM": (lambda: JM.xDeepFM(embed_size=E, num_fields=N, cin_layer_sizes=(6, 6),
                                   deep_layer_sizes=(8,)),
                dict(embed_size=E, num_fields=N, cin_layer_sizes=(6, 6), deep_layer_sizes=(8,)),
                lambda: [("feat_inputs", _feat()), ("emb_inputs", _emb())]),
    "NCF": (lambda: JM.NCF(deep_layer_sizes=(8,)), dict(embed_size=E, deep_layer_sizes=(8,)),
            lambda: [("emb_inputs", _draw(B, 2, E, seed=8))]),
    "WideAndDeep": (lambda: JM.WideAndDeep(deep_layer_sizes=(8,)),
                    dict(feat_size=N, num_fields=N, embed_size=E, deep_layer_sizes=(8,)),
                    lambda: [("feat_inputs", _feat()), ("emb_inputs", _emb())]),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_matches_the_jax_model_in_training_and_eval(case):
    make_jax, kwargs, make_inputs = MODEL_CASES[case]
    inputs = make_inputs()
    args = [a for _, a in inputs]
    jm = make_jax()
    variables = jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
                        *args)
    params = _randomize(variables["params"], seed=9, keep=CIN_BIASES)
    stats = variables.get("batch_stats")
    name = case.split("_")[0]
    port = from_flax_params(get_model(name, device="cpu", **kwargs), params,
                            batch_stats=stats)
    feed = {k: torch.from_numpy(a) for k, a in inputs}
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    want_train, mutated = jm.apply(variables, *args, training=True, mutable=["batch_stats"])
    port.train()
    got_train = port(**feed)
    assert got_train.shape == (B, 1)
    _close(got_train, want_train, rtol=1e-5, atol=1e-6)
    if stats:
        variables["batch_stats"] = mutated["batch_stats"]
        for path, buf in port.named_buffers():
            *mod, leaf = path.split(".")
            ref = mutated["batch_stats"]
            for part in mod:
                ref = ref[part]
            _close(buf, ref[leaf])
    port.eval()
    _close(port(**feed), jm.apply(variables, *args), rtol=1e-5, atol=1e-6)


def test_registry_resolves_the_jax_packages_names():
    for name in ("FMNN", "FactorizationMachineSupportedNeuralNetwork", "FFM", "AFM", "NFM",
                 "NeuralFactorizationMachine", "PNN", "ProductNeuralNetwork", "DCN",
                 "DeepAndCrossNetwork", "xDeepFM", "XDeepFM", "NCF",
                 "NeuralCollaborativeFiltering", "WideAndDeep"):
        assert name in MODELS and MODELS[name] is MODELS[MODELS[name].__name__]
        assert JAX_MODELS[name].__name__ == MODELS[name].__name__


def test_batch_stats_carry_over_needs_matching_buffers():
    jm = JM.xDeepFM(embed_size=E, num_fields=N, cin_layer_sizes=(6, 6), deep_layer_sizes=(8,))
    variables = jm.init(jax.random.PRNGKey(0), _feat(), _emb())
    stats = _randomize(variables["batch_stats"], seed=11)
    port = get_model("xDeepFM", device="cpu", embed_size=E, num_fields=N,
                     cin_layer_sizes=(6, 6), deep_layer_sizes=(8,))
    from_flax_params(port, variables["params"], batch_stats=stats)
    np.testing.assert_array_equal(port.cin.bn_1.var.numpy(), stats["cin"]["bn_1"]["var"])
    with pytest.raises(KeyError, match="no buffer"):
        from_flax_params(port, variables["params"], batch_stats={"cin": {"bn_9": stats["cin"]
                                                                         ["bn_0"]}})
