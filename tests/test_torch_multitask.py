"""The mixture-of-experts layer and the multi-task models (DeepMoE, MMoE,
ESMM, ESM², DeepMCP) against the JAX package's, from the same flax
parameters (``convert.from_flax_params``), and through the Trainer.

* ``MixtureOfExpertsLayer`` (one and three gates) and the five models in
  training and eval mode, float32 at rtol 1e-5; MMoE's, ESMM's and ESM²'s
  heads under bf16 (the JAX side jitted, as its Trainer runs it) to the
  bit (the port's ``Dense`` rounds the product and the bias's sum, as
  flax's does).
  The experts sit at flax's automatic paths
  (``_FlatMLPExpert_<i>/MultilayerPerceptionLayer_0``).
* ``Sequential`` casts each bf16 leaf of a tuple output to float32, as the
  JAX ``Sequential``'s ``tree_map`` does (ESMM under
  ``set_compute_dtype("bfloat16")``: before the repair a tuple has no
  ``dtype``).
* The Trainer (five free steps with the losses at rtol 1e-5, then one from
  the JAX Trainer's state with every parameter and the optimizer state
  held, ``test_torch_optim_train.run_both``): MMoE on a ``(B, 2)`` label
  with the registry's BCE on the presorted, on-device (both dedup
  settings) and dense routes, and at 2 steps a dispatch; ESMM with a
  callable criterion (``BCE(pCTR, click) + BCE(pCTR·pCVR, conversion)``)
  on the on-device route at E = 18 (pack 4 into stored rows of 72 floats)
  and on the dense route.
* Evaluation and prediction do what the JAX Trainer does: MMoE's AUC and
  logloss over both tasks; ESMM's ``predict`` gives its tuple, and its
  ``evaluate``, and DeepMCP's ``predict``, raise the JAX package's error
  type."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torecsys_tpu.layers as JL
import torecsys_tpu.models as JM
from test_torch_field_aware import B, ROUTES, STEPS, batches
from test_torch_optim_train import LR, Config, run_both, schema
from torecsys_tpu import inputs as J
from torecsys_tpu import losses as JLoss
from torecsys_tpu.layers.precision import use_compute_dtype
from torecsys_tpu.models.base import MODELS as JAX_MODELS
from torecsys_tpu.train import Pipeline as JaxPipeline
from torecsys_tpu.train import Trainer as JaxTrainer
from torecsys_tpu_torch import Pipeline, Trainer
from torecsys_tpu_torch import inputs as T
from torecsys_tpu_torch import layers as TL
from torecsys_tpu_torch import losses as TLoss
from torecsys_tpu_torch.convert import flatten, from_flax_params, torch_name
from torecsys_tpu_torch.layers.precision import apply_compute_dtype
from torecsys_tpu_torch.models import MODELS, get_model

N, E = 5, 8


def _draw(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _randomize(tree, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32) + rng.normal(size=np.shape(a)) * scale).astype(
            np.float32), tree)


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _close_tree(got, want, rtol):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(jnp.asarray(w).astype(jnp.float32)), rtol=rtol,
                                   atol=1e-6)


# ---- the MoE layer -------------------------------------------------------------

@pytest.mark.parametrize("gates", [1, 3])
def test_moe_layer_matches_the_jax_layer(gates):
    import functools

    from torecsys_tpu.models.ctr.multitask import _FlatMLPExpert as JaxExpert
    from torecsys_tpu_torch.models.ctr.multitask import _expert_factory

    x = _draw(4, N, E, seed=1)
    jl = JL.MixtureOfExpertsLayer(
        expert_factory=functools.partial(JaxExpert, output_size=4, layer_sizes=(8,)),
        num_experts=3, num_gates=gates)
    params = _randomize(jl.init(jax.random.PRNGKey(0), x)["params"], seed=2)
    port = from_flax_params(TL.MOELayer(N, E, _expert_factory(4, (8,), 0.0, torch.relu, "cpu"),
                                        3, gates, device="cpu"), params)
    assert set(dict(port.named_parameters())) == {torch_name(p) for p in flatten(params)}
    assert "_FlatMLPExpert_2.MultilayerPerceptionLayer_0.output.weight" in dict(
        port.named_parameters())
    got = port(torch.from_numpy(x))
    assert got.shape == (4, gates, 3 * 4)
    _close_tree(got, jl.apply({"params": params}, x), rtol=1e-5)


# ---- the models ------------------------------------------------------------------

MODEL_CASES = {
    # name: (JAX model, port kwargs, inputs {name: shape})
    "DeepMoE": (lambda: JM.DeepMoE(num_moe_layers=2, num_experts=3, num_gates=2,
                                   expert_output_size=4, expert_layer_sizes=(8,)),
                dict(num_fields=N, embed_size=E, num_moe_layers=2, num_experts=3, num_gates=2,
                     expert_output_size=4, expert_layer_sizes=(8,)),
                {"emb_inputs": (4, N, E)}),
    "MMoE": (lambda: JM.MMoE(num_tasks=3, num_experts=2, expert_output_size=4,
                             expert_layer_sizes=(8,), tower_layer_sizes=(8,)),
             dict(num_fields=N, embed_size=E, num_tasks=3, num_experts=2, expert_output_size=4,
                  expert_layer_sizes=(8,), tower_layer_sizes=(8,)),
             {"emb_inputs": (4, N, E)}),
    "ESMM": (lambda: JM.ESMM(deep_layer_sizes=(8, 8)), dict(num_fields=N, deep_layer_sizes=(8, 8)),
             {"emb_inputs": (4, N, E)}),
    "ESM2": (lambda: JM.ESM2(deep_layer_sizes=(8,)), dict(num_fields=N, deep_layer_sizes=(8,)),
             {"emb_inputs": (4, N, E)}),
    "DeepMCP": (lambda: JM.DeepMCP(pred_layer_sizes=(8,), match_layer_sizes=(8,),
                                   corr_layer_sizes=(8,)),
                dict(user_size=2 * E, content_size=3 * E, pred_layer_sizes=(8,),
                     match_layer_sizes=(8,), corr_layer_sizes=(8,)),
                {"user_emb_inputs": (4, 2, E), "content_emb_inputs": (4, 3, E),
                 "pos_emb_inputs": (4, 3, E), "neg_emb_inputs": (4, 2, 3 * E)}),
}


def _model_pair(case, seed=3):
    make_jax, kwargs, shapes = MODEL_CASES[case]
    args = {k: _draw(*s, seed=seed + i) for i, (k, s) in enumerate(shapes.items())}
    jm = make_jax()
    params = _randomize(jm.init({"params": jax.random.PRNGKey(0),
                                 "dropout": jax.random.PRNGKey(0)}, **args)["params"], seed + 9)
    port = from_flax_params(get_model(case, device="cpu", **kwargs), params)
    return jm, port, params, args


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_matches_the_jax_model_in_training_and_eval(case):
    jm, port, params, args = _model_pair(case)
    targs = {k: torch.from_numpy(v) for k, v in args.items()}
    port.train()
    _close_tree(port(**targs), jm.apply({"params": params}, **args, training=True), rtol=1e-5)
    port.eval()
    _close_tree(port(**targs), jm.apply({"params": params}, **args), rtol=1e-5)


# bf16 heads: the port's Dense rounds the product to bf16 and again after
# the bias, as flax's does, so the heads agree with the jitted JAX model to
# the bit.


@pytest.mark.parametrize("case", ["MMoE", "ESMM", "ESM2"])
def test_bf16_heads_match_the_jitted_jax_model(case):
    jm, port, params, args = _model_pair(case, seed=20)
    apply_compute_dtype(port, "bfloat16")
    with use_compute_dtype("bfloat16"):
        want = jax.jit(lambda p, a: jm.apply({"params": p}, **a))(params, args)
    got = port.eval()(**{k: torch.from_numpy(v) for k, v in args.items()})
    assert all(g.dtype == torch.bfloat16 for g in _leaves(got))
    assert all(w.dtype == jnp.bfloat16 for w in _leaves(want))
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_array_equal(g.float().detach().numpy(),
                                      np.asarray(w.astype(jnp.float32)))


def test_registry_resolves_the_jax_packages_names():
    names = ("DeepMoE", "DeepMixtureOfExperts", "MMoE", "MultiGateMixtureOfExperts", "ESMM",
             "EntireSpaceMultiTask", "ESM2", "ElaboratedEntireSpaceSupervisedMultiTask",
             "DeepMCP", "DeepMatchingCorrelationPrediction", "DSIN",
             "DeepSessionInterestNetwork")
    for name in names:
        assert MODELS[name] is MODELS[MODELS[name].__name__]
        assert JAX_MODELS[name].__name__ == MODELS[name].__name__
    assert MODELS["ESMM"].outputs_probability and MODELS["ESM2"].outputs_probability
    assert not MODELS["MMoE"].outputs_probability


def test_dsin_is_refused_by_its_roadmap_item():
    """DSIN was refused by its ROADMAP item until its slice ported it: it
    now builds as the JAX ``get_model`` builds it, with the JAX package's
    ``FutureWarning`` (``in_development``), with the same parameters
    (``test_torch_dsin`` holds its forward and its training)."""
    from torecsys_tpu.models.base import get_model as jax_get_model

    kwargs = {"embed_size": E, "max_num_session": 4, "max_num_position": 6}
    with pytest.warns(FutureWarning, match="in development"):
        port = get_model("DSIN", device="cpu", **kwargs)
    with pytest.warns(FutureWarning, match="in development"):
        jm = jax_get_model("DSIN", **kwargs)
    assert type(port).__name__ == type(jm).__name__
    x, idx = _draw(2, 6, E, seed=4), np.array([0, 3], np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        shapes = jax.tree.map(lambda a: a.shape,
                              jm.init(jax.random.PRNGKey(0), x, idx)["params"])
    assert {torch_name(p): s for p, s in flatten(shapes).items()} == {
        n: tuple(reversed(p.shape)) if n.endswith(".weight") else tuple(p.shape)
        for n, p in port.named_parameters()}


# ---- Sequential over a tuple output -------------------------------------------------

def test_sequential_casts_each_bf16_leaf_of_a_tuple_output():
    """ESMM's ``(pCVR, pCTR)`` under bf16: both float32, as the JAX
    ``Sequential`` gives them; other leaves pass as they are."""
    from torecsys_tpu_torch.models.sequential import _to_float32

    pipe = (Pipeline(device="cpu").set_inputs(T.Inputs(schema("emb", T)))
            .set_model("ESMM", deep_layer_sizes=(8,)).set_compute_dtype("bfloat16").finalize())
    assert pipe.model.cvr_deep.output.compute_dtype == torch.bfloat16
    batch = {k: torch.from_numpy(v) for k, v in batches(1)[0].items() if k != "label"}
    pcvr, pctr = pipe.sequential(batch)
    assert pcvr.dtype == pctr.dtype == torch.float32 and pcvr.shape == (B, 1)
    assert torch.equal(pctr, pipe.model(**pipe.inputs(batch))[1].float())
    bf = torch.ones(2, dtype=torch.bfloat16)
    out = _to_float32({"a": [bf, 3], "b": (bf, torch.ones(1, dtype=torch.int32))})
    assert out["a"][0].dtype == torch.float32 and out["a"][1] == 3
    assert out["b"][1].dtype == torch.int32 and isinstance(out["b"], tuple)


# ---- the Trainer --------------------------------------------------------------------

TASKS = 2
MMOE = (("num_tasks", TASKS), ("num_experts", 3), ("expert_output_size", 8),
        ("expert_layer_sizes", (16,)), ("tower_layer_sizes", (8,)))


def two_task_batches(n, seed=0):
    """``test_torch_field_aware.batches`` with a ``(B, 2)`` label: the click
    and, for clicked examples only, a drawn conversion."""
    rng = np.random.default_rng(seed + 100)
    out = []
    for b in batches(n, seed):
        click = b["label"].astype(np.float32)
        conversion = click * (rng.uniform(size=click.shape) < 0.4)
        out.append({**b, "label": np.stack([click, conversion], axis=1).astype(np.float32)})
    return out


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_mmoe_trainer_matches_the_jax_trainer_on_two_task_labels(route, monkeypatch):
    port, ref = run_both(Config("emb", "MMoE", MMOE, "Adam"), route, monkeypatch,
                         feed=two_task_batches(STEPS + 1))
    assert port.sparse == ROUTES[route].sparse
    feed = two_task_batches(2, seed=7)
    preds = port.predict(feed[0])
    assert preds.shape == (B, TASKS) and preds.dtype == torch.float32
    np.testing.assert_allclose(preds.numpy(), np.asarray(ref.t.predict(feed[0])), rtol=1e-5,
                               atol=1e-6)
    got, want = port.evaluate(feed), ref.t.evaluate(feed)
    assert set(got) == set(want) == {"val_auc", "val_logloss"}
    # as test_torch_eval holds them: a score on a histogram bin's edge may
    # land in the neighbouring bin
    np.testing.assert_allclose(got["val_auc"], want["val_auc"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["val_logloss"], want["val_logloss"], rtol=1e-5)


def test_mmoe_steps_per_execution_equals_single_steps():
    """Two steps a dispatch over a ``(B, 2)`` label (on the CPU the packed
    group runs eagerly) against two single steps from the same weights: the
    losses and parameters to the bit."""
    feed = two_task_batches(4)
    runs = []
    for spe in (1, 2):
        pipe = (Pipeline(device="cpu").set_inputs(T.Inputs(schema("emb", T)))
                .set_model("MMoE", **dict(MMOE)).set_optimizer("Adam", lr=LR)
                .set_sparse_embeddings(True))
        trainer = Trainer(pipe, presort=False, prefetch=0, steps_per_execution=spe)
        trainer.init_state()
        losses = [float(x) for x in trainer.train_steps(feed)]
        runs.append((losses, {n: p.detach().clone()
                              for n, p in pipe.sequential.named_parameters()}))
    assert runs[0][0] == runs[1][0]
    for name, value in runs[0][1].items():
        assert torch.equal(value, runs[1][1][name]), name


def esmm_loss(bce):
    """ESMM's criterion over ``(pCVR, pCTR)`` and a ``(B, 2)`` label of
    click and conversion: ``BCE(pCTR, click) + BCE(pCTR·pCVR,
    conversion)`` with the registry's ``bce``."""

    def criterion(preds, targets):
        pcvr, pctr = preds
        return bce(pctr, targets[:, 0]) + bce(pctr * pcvr, targets[:, 1])

    return criterion


def _esmm_pipelines(route_name, embed):
    route = ROUTES[route_name]
    jpipe = (JaxPipeline().set_objective("ctr")
             .set_inputs(J.Inputs(schema=schema("emb", J, embed)))
             .set_model("ESMM", deep_layer_sizes=(16, 8))
             .set_criterion(esmm_loss(JLoss.BCELoss())).set_optimizer("Adam", lr=LR)
             .set_sparse_embeddings(route.sparse).set_target_fields("label"))
    pipe = (Pipeline(device="cpu").set_objective("ctr")
            .set_inputs(T.Inputs(schema("emb", T, embed)))
            .set_model("ESMM", deep_layer_sizes=(16, 8))
            .set_criterion(esmm_loss(TLoss.BCELoss())).set_optimizer("Adam", lr=LR)
            .set_sparse_embeddings(route.sparse).set_target_fields("label"))
    return jpipe, pipe


@pytest.mark.parametrize("route_name,embed", [("ondevice", 18), ("dense", 8)])
def test_esmm_with_a_callable_criterion_matches_the_jax_trainer(route_name, embed, monkeypatch):
    """Five free steps, then one from the JAX Trainer's state, every
    parameter (the touched table rows among them) within atol 1e-6."""
    route = ROUTES[route_name]
    monkeypatch.setenv("TORECSYS_TPU_FUSED_DEDUP", route.fused)
    feed = two_task_batches(STEPS + 1, seed=3)
    jpipe, _ = _esmm_pipelines(route_name, embed)
    jt = JaxTrainer(jpipe, presort=route.presort, prefetch=0, seed=0)
    jt.init_state(feed[0])
    jt._build_steps()

    def jax_step(batch):
        with jt._trace_contexts():
            jt.state, logs = jt._train_step_fn(jt.state, jt._place_batch(batch))
        return float(logs["loss"])

    def port_trainer(opt_state=False):
        _, pipe = _esmm_pipelines(route_name, embed)
        t = Trainer(pipe, presort=route.presort, prefetch=0)
        t.init_state()
        from_flax_params(pipe.sequential, jax.device_get(jt.state.params),
                         jax.device_get(jt.state.opt_state) if opt_state else None,
                         t.state if opt_state else None,
                         step=int(jt.state.step) if opt_state else None)
        return t

    port = port_trainer()
    assert port.sparse == route.sparse
    table = port.pipeline.inputs.schema["emb_inputs"]
    if embed == 18:
        assert table.pack == 4 and table.embedding.shape[-1] == 72
    want = [jax_step(b) for b in feed[:STEPS]]
    got = [float(x) for x in port.train_steps(feed[:STEPS])]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    port = port_trainer(opt_state=True)
    np.testing.assert_allclose(float(port.train_steps(feed[STEPS:])[0]), jax_step(feed[STEPS]),
                               rtol=1e-5)
    named = dict(port.pipeline.sequential.named_parameters())
    for path, ref in flatten(jax.device_get(jt.state.params)).items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(named[torch_name(path)].detach().numpy(),
                                   ref.T if path.endswith("kernel") else ref, rtol=0, atol=1e-6,
                                   err_msg=path)
    # predict gives the tuple, as the JAX Trainer's eval step does
    pcvr, pctr = port.predict(feed[0])
    want_cvr, want_ctr = jt.predict(feed[0])
    np.testing.assert_allclose(pctr.numpy(), np.asarray(want_ctr), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pcvr.numpy(), np.asarray(want_cvr), rtol=1e-5, atol=1e-6)


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the error type is compared
        return type(e)
    return None


def test_tuple_output_evaluation_and_prediction_fail_as_in_the_jax_package():
    """The JAX Trainer's ``evaluate`` takes one score tensor: ESMM's tuple
    raises there, and DeepMCP's ``predict`` (a sigmoid over its tuple)
    raises; the port raises the same error types."""
    feed = two_task_batches(1)
    jpipe, pipe = _esmm_pipelines("dense", 8)
    jt = JaxTrainer(jpipe, prefetch=0)
    jt.init_state(feed[0])
    port = Trainer(pipe, prefetch=0)
    port.init_state()
    want = _raised(lambda: jt.evaluate(feed))
    assert want is not None and _raised(lambda: port.evaluate(feed)) is want

    users, items = T.SingleIndexEmbedding(300, E, ("cat_0",), device="cpu"), \
        T.SingleIndexEmbedding(200, E, ("cat_1",), device="cpu")
    mcp_inputs = T.Inputs({"user_emb_inputs": users, "content_emb_inputs": items,
                           "pos_emb_inputs": items, "neg_emb_inputs": items})
    jusers = J.SingleIndexEmbedding(field_size=300, embed_size=E, fields=("cat_0",))
    jitems = J.SingleIndexEmbedding(field_size=200, embed_size=E, fields=("cat_1",))
    jmcp = J.Inputs(schema={"user_emb_inputs": jusers, "content_emb_inputs": jitems,
                            "pos_emb_inputs": jitems, "neg_emb_inputs": jitems})
    kwargs = dict(pred_layer_sizes=(8,), match_layer_sizes=(8,), corr_layer_sizes=(8,))
    jt = JaxTrainer(JaxPipeline().set_inputs(jmcp).set_model("DeepMCP", **kwargs), prefetch=0)
    jt.init_state(feed[0])
    port = Trainer(Pipeline(device="cpu").set_inputs(mcp_inputs).set_model("DeepMCP", **kwargs),
                   prefetch=0)
    port.init_state()
    assert port.pipeline.model.correlation.dense_0.weight.shape == (8, E)
    want = _raised(lambda: jt.predict(feed[0]))
    assert want is not None and _raised(lambda: port.predict(feed[0])) is want


@pytest.mark.parametrize("model", ['{"method": "MMoE", "num_tasks": 2, "num_experts": 3}',
                                   '{"method": "ESM2", "deep_layer_sizes": [8]}',
                                   '{"method": "DeepMoE", "num_moe_layers": 2}'])
def test_the_cli_builds_the_models_as_the_jax_cli(model):
    import json

    from torecsys_tpu.cli import _build_inputs as jax_build_inputs
    from torecsys_tpu_torch.cli import run

    inputs = json.dumps({"emb_inputs": {"method": "MultiIndicesEmbedding", "embed_size": 4,
                                        "field_sizes": [50, 9, 7], "fields": ["a", "b", "c"]}})
    pipe = run(["build", "--device", "cpu", "--model_config", model, "--inputs_config", inputs])
    jpipe = JaxPipeline.build(inputs_config=jax_build_inputs(json.loads(inputs)),
                              model_config=json.loads(model))
    assert type(pipe.model).__name__ == type(jpipe.model).__name__
    batch = {"a": np.array([1, 49], np.int32), "b": np.array([0, 8], np.int32),
             "c": np.array([6, 2], np.int32)}
    jseq = jpipe.sequential
    params = jseq.init(jax.random.PRNGKey(0), batch)["params"]
    from_flax_params(pipe.sequential, params)
    _close_tree(pipe.sequential({k: torch.from_numpy(v) for k, v in batch.items()}),
                jseq.apply({"params": params}, batch), rtol=1e-5)
