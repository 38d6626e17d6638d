"""FiBiNET, DeepFFM and FAT-DeepFFM, and their layers, against the JAX
package's from the same flax parameters (``convert.from_flax_params``).

* Layers (float32, rtol 1e-6 / atol 1e-6): the excitation network
  (``ComposeExcitationNetworkLayer``, squared and not, reduction 1 and 3),
  the three FiBiNET bilinear types through the ``BilinearInteractionLayer``
  dispatcher (whose unknown type raises ``ValueError`` on both sides), and
  the residual ``BilinearNetworkLayer`` at rtol / atol 1e-5: each of its
  outputs sums D² = 1,600 products of up to about 4, which XLA and torch
  add in other orders.  Every parameter that flax initializes to a
  constant (the biases) is moved by a numpy draw first.
* Models: FiBiNET on each bilinear type, DeepFFM and FAT-DeepFFM, in
  training and in eval mode, rtol 1e-5; the registry's names and aliases.
* The Trainer (``test_torch_optim_train.run_both``: five free steps with
  the losses at rtol 1e-5, then a sixth from the JAX Trainer's state and the
  whole state held): FiBiNET on the presorted, on-device and dense routes,
  and at E = 10 (pack 8 into a stored width of 80, the narrowest packed row
  and the first with E not a multiple of 4) on the sparse routes; DeepFFM
  under Adam and FAT-DeepFFM under Adagrad on the field-aware sparse route
  (on-device, both ``TORECSYS_TPU_FUSED_DEDUP`` settings) and the dense one.
* The regularizer selects FiBiNET's parameters by their flax paths: the
  bilinear ``weight`` is not a Dense ``kernel``."""

import jax
import numpy as np
import pytest
import torch

import torecsys_tpu.layers as JL
import torecsys_tpu.models as JM
from test_torch_optim_train import Config, run_both
from torecsys_tpu.models.base import MODELS as JAX_MODELS
from torecsys_tpu.utils.operations import regularize as jax_regularize
from torecsys_tpu_torch import layers as TL
from torecsys_tpu_torch.convert import flax_paths, from_flax_params
from torecsys_tpu_torch.models import MODELS, get_model
from torecsys_tpu_torch.utils.operations import regularize

B, N, E = 4, 5, 8


def _randomize(tree, seed):
    """A flax tree as numpy, each constant leaf (a zeros init) moved by
    N(0, 0.5²) draws."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a, dtype=np.float32)
        if a.size == 0 or not np.all(a == a.flat[0]):
            return a
        return (a + rng.normal(size=a.shape) * 0.5).astype(np.float32)

    return jax.tree.map(move, tree)


def _draw(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, dtype=np.float32),
                               rtol=rtol, atol=atol)


LAYER_TOL = {"bilinear_network": 1e-5}
LAYERS = {
    "cen": (lambda: JL.ComposeExcitationNetworkLayer(num_fields=N),
            lambda: TL.ComposeExcitationNetworkLayer(N, device="cpu"), (B, N, E)),
    "cen_reduction3": (lambda: JL.ComposeExcitationNetworkLayer(num_fields=N, reduction=3),
                       lambda: TL.ComposeExcitationNetworkLayer(N, 3, device="cpu"), (B, N, E)),
    "cen_squared": (lambda: JL.ComposeExcitationNetworkLayer(num_fields=N, squared=True),
                    lambda: TL.ComposeExcitationNetworkLayer(N, squared=True, device="cpu"),
                    (B, N * N, E)),
    "cen_squared_reduction3": (
        lambda: JL.ComposeExcitationNetworkLayer(num_fields=N, reduction=3, squared=True),
        lambda: TL.SENETLayer(N, 3, squared=True, device="cpu"), (B, N * N, E)),
    "bilinear_network": (lambda: JL.BilinearNetworkLayer(num_layers=2),
                         lambda: TL.BilinearNetworkLayer(2, N * E, device="cpu"), (B, N, E)),
    **{f"bilinear_{t}": (
        lambda t=t: JL.BilinearInteractionLayer(num_fields=N, embed_size=E, bilinear_type=t),
        lambda t=t: TL.BilinearInteractionLayer(N, E, t, device="cpu"), (B, N, E))
       for t in ("all", "each", "interaction")},
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_the_jax_layer(name):
    make_jax, make_port, shape = LAYERS[name]
    x = _draw(*shape, seed=1) + 0.5  # the excitation's ReLUs see both signs
    jl = make_jax()
    params = _randomize(jl.init(jax.random.PRNGKey(0), x)["params"], seed=2)
    want = jl.apply({"params": params}, x)
    port = from_flax_params(make_port(), params)
    got = port(torch.from_numpy(x))
    assert got.shape == want.shape
    tol = LAYER_TOL.get(name, 1e-6)
    _close(got, want, rtol=tol, atol=tol)


def test_bilinear_layers_keep_flaxs_weight_layout_and_refuse_unknown_types():
    layer = TL.BilinearInteractionLayer(N, E, "each", device="cpu")
    assert tuple(layer.bilinear.weight.shape) == (N, E, E)
    assert flax_paths(layer) == {"bilinear.weight": "bilinear/weight"}
    p = N * (N - 1) // 2
    assert tuple(TL.FieldInteractionTypeBilinear(N, E, device="cpu").weight.shape) == (p, E, E)
    with pytest.raises(ValueError, match="unknown bilinear_type"):
        TL.BilinearInteractionLayer(N, E, "pairwise", device="cpu")
    with pytest.raises(ValueError, match="unknown bilinear_type"):
        JL.BilinearInteractionLayer(num_fields=N, embed_size=E, bilinear_type="pairwise").init(
            jax.random.PRNGKey(0), _draw(B, N, E))
    for alias in ("CENLayer", "SENETLayer", "SqueezeAndExcitationNetworkLayer"):
        assert getattr(TL, alias) is TL.ComposeExcitationNetworkLayer
        assert getattr(JL, alias).__name__ == "ComposeExcitationNetworkLayer"


MODEL_CASES = {
    # name: (JAX model, port kwargs, input name, input shape)
    **{f"FiBiNET_{t}": (
        lambda t=t: JM.FiBiNET(num_fields=N, embed_size=E, senet_reduction=3,
                               deep_layer_sizes=(8,), bilinear_type=t),
        dict(num_fields=N, embed_size=E, senet_reduction=3, deep_layer_sizes=(8,),
             bilinear_type=t), "emb_inputs", (B, N, E)) for t in ("all", "each", "interaction")},
    "DeepFFM": (lambda: JM.DeepFFM(num_fields=N, deep_layer_sizes=(8, 8)),
                dict(num_fields=N, embed_size=E, deep_layer_sizes=(8, 8)), "field_emb_inputs",
                (B, N * N, E)),
    "FATDeepFFM": (lambda: JM.FATDeepFFM(num_fields=N, reduction=2, deep_layer_sizes=(8,)),
                   dict(num_fields=N, embed_size=E, reduction=2, deep_layer_sizes=(8,)),
                   "field_emb_inputs", (B, N * N, E)),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_matches_the_jax_model_in_training_and_eval(case):
    make_jax, kwargs, key, shape = MODEL_CASES[case]
    x = _draw(*shape, seed=3) + 0.5
    jm = make_jax()
    params = _randomize(jm.init({"params": jax.random.PRNGKey(0),
                                 "dropout": jax.random.PRNGKey(0)}, x)["params"], seed=4)
    port = from_flax_params(get_model(case.split("_")[0], device="cpu", **kwargs), params)
    want = jm.apply({"params": params}, x, training=True)
    port.train()
    got = port(**{key: torch.from_numpy(x)})
    assert got.shape == (B, 1)
    _close(got, want, rtol=1e-5)
    port.eval()
    _close(port(**{key: torch.from_numpy(x)}), jm.apply({"params": params}, x), rtol=1e-5)


def test_registry_resolves_the_jax_packages_names():
    for name in ("FiBiNET", "DeepFFM", "FNFM", "FieldAwareNeuralFactorizationMachine",
                 "FATDeepFFM", "FieldAttentiveDeepFieldAwareFactorizationMachine"):
        assert name in MODELS and MODELS[name] is MODELS[MODELS[name].__name__]
        assert JAX_MODELS[name].__name__ == MODELS[name].__name__


def test_regularizer_selects_fibinets_parameters_by_flax_path():
    """``key_filter="kernel"`` takes the Dense kernels (the SENET's and the
    tower's) and leaves the bilinear weights out, as in the JAX
    package; ``"weight"`` takes exactly those."""
    jm = JM.FiBiNET(num_fields=N, embed_size=E, deep_layer_sizes=(8,))
    params = _randomize(jm.init(jax.random.PRNGKey(0), _draw(B, N, E))["params"], seed=5)
    port = from_flax_params(get_model("FiBiNET", device="cpu", num_fields=N, embed_size=E,
                                      deep_layer_sizes=(8,)), params)
    for key_filter in ("kernel", "weight", "bias"):
        want = float(jax_regularize(params, weight_decay=0.01, norm=2, key_filter=key_filter))
        got = float(regularize(port.requires_grad_(False), weight_decay=0.01, norm=2, key_filter=key_filter))
        assert got == pytest.approx(want, rel=1e-6)


NUM_FIELDS = 5  # test_torch_field_aware.FIELDS


def fibinet(embed=8, deep=(16, 16), **kwargs):
    """FiBiNET's Config at ``embed``; the JAX model takes its widths as
    arguments, the port's would read them off the inputs."""
    widths = {"num_fields": NUM_FIELDS, "embed_size": embed, "deep_layer_sizes": deep}
    return Config("emb", "FiBiNET", tuple({**widths, **kwargs}.items()), "Adam", embed=embed)


def field_aware(model, optimizer):
    return Config("field", model, (("num_fields", NUM_FIELDS), ("deep_layer_sizes", (16,))),
                  optimizer, embed=4)


TRAIN_CASES = {
    "fibinet_presorted": (fibinet(senet_reduction=3), "presorted"),
    "fibinet_ondevice": (fibinet(senet_reduction=3), "ondevice"),
    "fibinet_dense": (fibinet(senet_reduction=3), "dense"),
    "fibinet_each_ondevice_fused": (fibinet(deep=(16,), bilinear_type="each"),
                                    "ondevice_fused"),
    "fibinet_interaction_dense": (fibinet(deep=(16,), bilinear_type="interaction"), "dense"),
    "fibinet_e10_presorted": (fibinet(10, senet_reduction=3), "presorted"),
    "fibinet_e10_ondevice": (fibinet(10, senet_reduction=3), "ondevice"),
    "fibinet_e10_ondevice_fused": (fibinet(10, senet_reduction=3), "ondevice_fused"),
    "deepffm_ondevice": (field_aware("DeepFFM", "Adam"), "ondevice"),
    "deepffm_dense": (field_aware("DeepFFM", "Adam"), "dense"),
    "fatdeepffm_adagrad_ondevice": (field_aware("FATDeepFFM", "Adagrad"), "ondevice"),
    "fatdeepffm_adagrad_ondevice_fused": (field_aware("FATDeepFFM", "Adagrad"), "ondevice_fused"),
    "fatdeepffm_adagrad_presorted": (field_aware("FATDeepFFM", "Adagrad"), "presorted"),
    "fatdeepffm_adagrad_dense": (field_aware("FATDeepFFM", "Adagrad"), "dense"),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_trainer_matches_the_jax_trainer(case, monkeypatch):
    config, route = TRAIN_CASES[case]
    port, _ = run_both(config, route, monkeypatch)
    table = next(iter(port.pipeline.inputs.schema.values()))
    if config.embed == 10:
        assert table.pack == 8 and table.embedding.shape[-1] == 80


@pytest.mark.parametrize("model,table", [
    ('{"method": "FiBiNET", "senet_reduction": 3, "bilinear_type": "each"}',
     "MultiIndicesEmbedding"),
    ('{"method": "FNFM", "deep_layer_sizes": [8]}', "MultiIndicesFieldAwareEmbedding"),
    ('{"method": "FATDeepFFM", "deep_layer_sizes": [8]}', "MultiIndicesFieldAwareEmbedding")])
def test_the_cli_builds_the_models(model, table):
    import json

    from torecsys_tpu_torch.cli import run

    key = "field_emb_inputs" if "FieldAware" in table else "emb_inputs"
    inputs = json.dumps({key: {"method": table, "embed_size": 10, "field_sizes": [50, 9, 7],
                               "fields": ["a", "b", "c"]}})
    pipe = run(["build", "--device", "cpu", "--model_config", model, "--inputs_config", inputs,
                "--optimizer_config", '{"method": "Adagrad", "lr": 0.05}'])
    assert type(pipe.model).__name__ == MODELS[json.loads(model)["method"]].__name__
    batch = {"a": torch.tensor([1, 49]), "b": torch.tensor([0, 8]), "c": torch.tensor([6, 2])}
    assert pipe.sequential(batch).shape == (2, 1)
