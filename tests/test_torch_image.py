"""The image inputs (``torecsys_tpu_torch/inputs/image.py``) against the JAX
package's (``torecsys_tpu/inputs/image.py``).

* ``ImageInput`` from the same flax variables (``convert.from_flax_params``,
  the 4-D kernel rule): the forward and every parameter's gradient at
  strides 1 and 2, odd image sizes and an even kernel (flax's asymmetric
  ``'SAME'`` padding), with and without BatchNorm, in training (the running
  statistics moved) and eval mode; rtol 1e-5 of the largest value (the
  convolutions sum in another order than XLA's).  uint8 pixels are input.
* Dropout: the JAX bits cannot be had; its shape, its rate and eval mode's
  identity are held.
* ``PretrainedImageInput``: a ``.npz`` the JAX ``save_tower_weights`` writes
  loads in the port and one the port writes loads in the JAX package, each
  giving the other's output; each branch's trained parameters are the JAX
  package's (a plain callable owns none, a module passed as the backbone is
  adopted).
* A DeepFM over ``StackedInput{MultiIndicesEmbedding, ImageInput}`` through
  the port's Trainer against the JAX Trainer from the same weights on the
  presorted, on-device and dense routes: 5 steps, losses rtol 1e-5, the
  running statistics held; the uint8 image field rides in the packed batch.
* The CLI builds both image inputs as the JAX CLI builds them.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from torecsys_tpu import inputs as J
from torecsys_tpu.cli import _build_inputs as jax_build_inputs
from torecsys_tpu.data.sample_data import make_synthetic_ctr
from torecsys_tpu.inputs.image import save_tower_weights as jax_save_tower_weights
from torecsys_tpu.train import Pipeline as JaxPipeline
from torecsys_tpu.train import Trainer as JaxTrainer
from torecsys_tpu_torch import Pipeline, Trainer
from torecsys_tpu_torch import inputs as T
from torecsys_tpu_torch.cli import _build_inputs
from torecsys_tpu_torch.convert import (flatten, flax_array, flax_path, flax_paths,
                                        from_flax_params)
from torecsys_tpu_torch.inputs.image import same_padding, save_tower_weights
from torecsys_tpu_torch.layers.ctr.dense import Dense
from torecsys_tpu_torch.train.state import batch_stats

B, C, E = 4, 3, 5
TOWER = dict(layers_size=(4, 6))


def images(h, w, seed=0, b=B):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, C)).astype(np.uint8)


def jax_tower(**kw):
    return J.ImageInput(embed_size=E, in_channels=C, **{**TOWER, **kw})


def port_tower(variables, **kw):
    tower = T.ImageInput(E, C, device="cpu", **{**TOWER, **kw})
    from_flax_params(tower, jax.device_get(variables["params"]),
                     batch_stats=jax.device_get(variables.get("batch_stats")) or None)
    return tower


def assert_close(got, want, rtol=1e-5, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * max(float(np.abs(want).max()), 1e-6), err_msg=msg)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("batchnorm", [True, False], ids=["bn", "nobn"])
@pytest.mark.parametrize("size,stride,kernel", [((8, 8), 1, 3), ((15, 17), 2, 3),
                                                ((15, 17), 1, 4), ((12, 16), 2, 2)],
                         ids=["8x8-s1-k3", "15x17-s2-k3", "15x17-s1-k4", "12x16-s2-k2"])
def test_image_input_forward_and_gradients(size, stride, kernel, batchnorm, training):
    x = images(*size)
    kw = dict(strides=(stride, stride), kernel_sizes=(kernel, kernel), use_batchnorm=batchnorm)
    jm = jax_tower(**kw)
    variables = jm.init(jax.random.PRNGKey(0), {"image": x})
    cot = np.random.default_rng(1).normal(size=(B, 1, E)).astype(np.float32)

    def loss(params):
        v = {**variables, "params": params}
        if training:
            out, mut = jm.apply(v, {"image": x}, training=True, mutable=["batch_stats"])
        else:
            out, mut = jm.apply(v, {"image": x}), {}
        return jnp.sum(out * cot), (out, mut)

    (_, (want, mut)), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    tower = port_tower(variables, **kw).train(training)
    out = tower({"image": torch.from_numpy(x)})
    (out * torch.from_numpy(cot)).sum().backward()
    assert out.dtype == torch.float32 and tuple(out.shape) == (B, 1, E)
    assert_close(out.detach().numpy(), want, msg="output")
    named = dict(tower.named_parameters())
    flat = flatten(jax.device_get(grads))
    largest = max(float(np.abs(g).max()) for g in flat.values())
    for name, path in flax_paths(tower).items():
        got = flax_array(path, named[name].grad)
        if batchnorm and training and path.endswith("/bias") and path.startswith("conv_"):
            # a bias right before a training BatchNorm: gradient 0 in exact
            # arithmetic, rounding noise on both sides (as the CIN's)
            assert max(np.abs(got).max(), np.abs(flat[path]).max()) <= 1e-5 * largest, path
            continue
        assert_close(got, flat[path], msg=path)
    stats = batch_stats(tower)
    for path, ref in flatten(jax.device_get(mut.get("batch_stats", variables.get(
            "batch_stats", {})))).items():
        assert_close(stats[path.replace("/", ".")].numpy(), ref, msg=path)


@pytest.mark.parametrize("size,kernel,stride", [(15, 3, 2), (16, 4, 2), (17, 2, 1), (5, 3, 1),
                                                (7, 5, 3)])
def test_same_padding_is_flaxs(size, kernel, stride):
    """The output size of flax's ``'SAME'`` convolution, and its padding's
    split (low ``total // 2``), against ``jax.lax``'s own rule."""
    lo, hi = same_padding(size, kernel, stride)
    (want,) = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")
    assert (lo, hi) == tuple(want)
    assert (size + lo + hi - kernel) // stride + 1 == -(-size // stride)


def test_conv_kernel_layout_round_trip():
    """flax's ``(kh, kw, in, out)`` kernel is the port's ``(out, in, kh,
    kw)`` weight, and ``flax_array`` gives it back."""
    variables = jax_tower().init(jax.random.PRNGKey(3), {"image": images(8, 8)})
    tower = port_tower(variables)
    kernel = np.asarray(variables["params"]["conv_1"]["kernel"])
    np.testing.assert_array_equal(tower.conv_1.weight.detach().numpy(),
                                  kernel.transpose(3, 2, 0, 1))
    for name, path in flax_paths(tower).items():
        np.testing.assert_array_equal(flax_array(path, dict(tower.named_parameters())[name]),
                                      flatten(jax.device_get(variables["params"]))[path])


def test_dropout_shape_rate_and_eval_identity():
    torch.manual_seed(0)  # dropout draws from torch's default generator
    tower = T.ImageInput(E, C, dropout_rate=0.5, device="cpu", **TOWER)
    x = torch.from_numpy(images(8, 8, b=64))
    tower.eval()
    a, b = tower({"image": x}), tower({"image": x})
    assert torch.equal(a, b) and tuple(a.shape) == (64, 1, E)
    tower.train()
    seen = []
    tower.dropout.register_forward_hook(lambda m, i, o: seen.append((i[0] != 0, o == 0)))
    out = tower({"image": x})
    assert tuple(out.shape) == (64, 1, E) and torch.isfinite(out).all()
    live = torch.cat([a.reshape(-1) for a, _ in seen])
    dropped = torch.cat([(a & b).reshape(-1) for a, b in seen])
    assert abs(dropped.sum().item() / live.sum().item() - 0.5) < 0.02


def test_tower_computes_in_float32_under_bf16():
    """The JAX package builds the tower without ``dtype=``: float32 under a
    bf16 compute dtype, its head too."""
    from torecsys_tpu_torch.layers.precision import apply_compute_dtype

    tower = T.ImageInput(E, C, device="cpu", **TOWER)
    apply_compute_dtype(tower, "bfloat16")
    assert tower.head.compute_dtype is None
    assert tower({"image": torch.from_numpy(images(8, 8))}).dtype == torch.float32


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tower_npz_loads_in_both_packages(writer, tmp_path):
    """``save_tower_weights``' flat ``.npz`` (``params/...`` in flax's
    layout, ``batch_stats/...``): written by either package, a
    ``PretrainedImageInput`` over it gives the same output in both, from the
    same head."""
    x = images(12, 12)
    jm = J.ImageInput(embed_size=8, in_channels=C)
    variables = jm.init(jax.random.PRNGKey(4), {"image": x})
    # move the running statistics off their init
    _, mut = jm.apply(variables, {"image": x}, training=True, mutable=["batch_stats"])
    variables = {**variables, "batch_stats": mut["batch_stats"]}
    path = str(tmp_path / f"tower_{writer}.npz")
    if writer == "jax":
        jax_save_tower_weights(path, jax.device_get(variables))
    else:
        tower = T.ImageInput(8, C, device="cpu")
        from_flax_params(tower, jax.device_get(variables["params"]),
                         batch_stats=jax.device_get(variables["batch_stats"]))
        save_tower_weights(path, tower)
    with np.load(path) as z:
        assert sorted(z.files) == sorted(f"{c}/{p}" for c in ("params", "batch_stats")
                                         for p in flatten(jax.device_get(variables[c])))
    jp = J.PretrainedImageInput(embed_size=E, weights_path=path, backbone_embed_size=8)
    jv = jp.init(jax.random.PRNGKey(5), {"image": x})
    assert list(flatten(jax.device_get(jv["params"]))) == ["head/bias", "head/kernel"]
    port = T.PretrainedImageInput(E, weights_path=path, backbone_embed_size=8, device="cpu")
    from_flax_params(port, jax.device_get(jv["params"]))
    assert_close(port({"image": torch.from_numpy(x)}).detach().numpy(),
                 jp.apply(jv, {"image": x}))
    # the tower's tensors are constants: no parameters, no buffers, in eval mode
    assert list(dict(port.named_parameters())) == ["head.weight", "head.bias"]
    assert not list(port.buffers()) and not port._tower.training


def test_pretrained_branches_train_the_jax_packages_parameters(tmp_path):
    """Each branch's trained parameters are the JAX package's: the frozen
    tower's none but ``head``; a plain callable none; a module passed as the
    backbone its own (adopted as ``backbone``, frozen or not); the fallback
    tower all of it."""
    x = images(8, 8)
    path = str(tmp_path / "t.npz")
    tv = J.ImageInput(embed_size=6, in_channels=C).init(jax.random.PRNGKey(0), {"image": x})
    jax_save_tower_weights(path, jax.device_get(tv))
    flat_w = 8 * 8 * C
    cases = {
        "weights_path": (dict(weights_path=path, backbone_embed_size=6),
                         dict(weights_path=path, backbone_embed_size=6)),
        "callable": (dict(backbone=lambda im: im.reshape(im.shape[0], -1) * 0.01),
                     dict(backbone=lambda im: im.reshape(im.shape[0], -1) * 0.01,
                          backbone_features=flat_w)),
        "module": (dict(backbone=fnn.Dense(7)),
                   dict(backbone=Dense(C, 7, follows_pipeline=False, device="cpu"),
                        backbone_features=8 * 8 * 7)),
        "fallback": ({}, {}),
    }
    for branch, (jkw, tkw) in cases.items():
        jm = J.PretrainedImageInput(embed_size=E, **jkw)
        jv = jm.init(jax.random.PRNGKey(1), {"image": x})
        want = sorted(flatten(jax.device_get(jv["params"])))
        tm = T.PretrainedImageInput(E, device="cpu", **tkw)
        assert sorted(flax_paths(tm).values()) == want, branch
        from_flax_params(tm, jax.device_get(jv["params"]),
                         batch_stats=jax.device_get(jv.get("batch_stats")) or None)
        tm.eval()
        out = tm({"image": torch.from_numpy(x)})
        assert_close(out.detach().numpy(), jm.apply(jv, {"image": x}), msg=branch)


def test_a_frozen_backbone_module_gets_no_gradient():
    """``frozen=True`` detaches the backbone's output: its module's
    parameters stay parameters (the optimizer's zero gradient moves them as
    optax moves a leaf of gradient 0), and receive none."""
    backbone = Dense(C, 7, follows_pipeline=False, device="cpu")
    tm = T.PretrainedImageInput(E, backbone=backbone, backbone_features=8 * 8 * 7,
                                device="cpu")
    tm({"image": torch.from_numpy(images(8, 8))}).sum().backward()
    assert backbone.weight.grad is None and tm.head.weight.grad is not None


FIELDS = (300, 200, 100)
CATS = tuple(f"cat_{i}" for i in range(len(FIELDS)))
DENSE = ("dense_0", "dense_1")
TB, HW = 32, 8


def image_batches(n, seed=0):
    data = make_synthetic_ctr(num_rows=TB * n, field_sizes=FIELDS, num_dense=len(DENSE),
                              seed=seed)
    data["image"] = images(HW, HW, seed, b=TB * n)
    return [{k: v[i * TB:(i + 1) * TB] for k, v in data.items()} for i in range(n)]


def image_schema(port):
    if port:
        return {"feat_inputs": T.ValueInput(DENSE), "emb_inputs": T.StackedInput([
            T.MultiIndicesEmbedding(4, FIELDS, CATS, device="cpu"),
            T.ImageInput(4, C, device="cpu", **TOWER)])}
    return {"feat_inputs": J.ValueInput(fields=DENSE), "emb_inputs": J.StackedInput(inputs=(
        J.MultiIndicesEmbedding(embed_size=4, field_sizes=FIELDS, fields=CATS),
        J.ImageInput(embed_size=4, in_channels=C, **TOWER)))}


@pytest.mark.parametrize("sparse,presort", [(True, True), (True, False), (False, None)],
                         ids=["presorted", "ondevice", "dense"])
def test_deepfm_with_an_image_tower_tracks_the_jax_trainer(sparse, presort):
    feed = image_batches(6)
    jp = (JaxPipeline().set_objective("ctr").set_inputs(J.Inputs(schema=image_schema(False)))
          .set_model("DeepFM", deep_layer_sizes=(8,)).set_criterion("BCEWithLogitsLoss")
          .set_optimizer("Adam", lr=1e-3).set_sparse_embeddings(sparse)
          .set_target_fields("label"))
    jt = JaxTrainer(jp, presort=presort, prefetch=0, seed=0)
    jt.init_state(feed[0])
    jt._setup_presorter()
    jt._build_steps()
    pipe = (Pipeline(device="cpu").set_objective("ctr").set_inputs(T.Inputs(image_schema(True)))
            .set_model("DeepFM", deep_layer_sizes=(8,)).set_criterion("BCEWithLogitsLoss")
            .set_optimizer("Adam", lr=1e-3).set_sparse_embeddings(sparse)
            .set_target_fields("label"))
    port = Trainer(pipe, presort=presort, prefetch=0)
    port.init_state()
    from_flax_params(pipe.sequential, jax.device_get(jt.state.params),
                     batch_stats=jax.device_get(jt.state.batch_stats))

    def jax_step(batch):
        if jt._presorter is not None:
            batch = jt._presorter(batch)
        with jt._trace_contexts():
            jt.state, logs = jt._train_step_fn(jt.state, jt._place_batch(batch))
        return float(logs["loss"])

    want = [jax_step(b) for b in feed[:5]]
    got = [float(v) for v in port.train_steps(feed[:5])]
    assert port.sparse == sparse and (port._presorter is not None) == bool(presort)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # a sixth step of each from the JAX Trainer's state, and the whole state
    # held after it (runs left alone part under rounding: the convolutions'
    # biases before a BatchNorm have gradient 0 in exact arithmetic, and
    # Adam turns their noise into steps that shift the running means)
    port = Trainer(pipe, presort=presort, prefetch=0)
    port.init_state()
    from_flax_params(pipe.sequential, jax.device_get(jt.state.params),
                     jax.device_get(jt.state.opt_state), port.state,
                     batch_stats=jax.device_get(jt.state.batch_stats))
    np.testing.assert_allclose(float(port.train_steps(feed[5:])[0]), jax_step(feed[5]),
                               rtol=1e-5)
    named = dict(pipe.sequential.named_parameters())
    for name, path in flax_paths(pipe.sequential).items():
        if re.search(r"conv_\d+/bias$", path):
            continue
        ref = flatten(jax.device_get(jt.state.params))[path]
        np.testing.assert_allclose(flax_array(path, named[name]), np.asarray(ref), rtol=0,
                                   atol=1e-6, err_msg=path)
    stats = batch_stats(pipe.sequential)
    want_stats = flatten(jax.device_get(jt.state.batch_stats))
    assert len(want_stats) == 4
    for path, ref in want_stats.items():
        name = path.replace("schema_", "schema.").replace("inputs_1", "inputs.1").replace(
            "/", ".")
        np.testing.assert_allclose(stats[name].numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6, err_msg=path)


def test_cli_builds_the_image_inputs(tmp_path):
    """``_build_inputs`` builds ``ImageInput`` and ``PretrainedImageInput``
    (with ``weights_path``) from the JSON the JAX CLI takes, to the same
    parameter paths."""
    path = str(tmp_path / "t.npz")
    tv = J.ImageInput(embed_size=6, in_channels=C).init(jax.random.PRNGKey(0),
                                                        {"image": images(8, 8)})
    jax_save_tower_weights(path, jax.device_get(tv))
    cfg = {"image_inputs": {"method": "ImageInput", "embed_size": 4, "in_channels": C,
                            "layers_size": [3, 5], "strides": [2, 1]},
           "pre_inputs": {"method": "PretrainedImageInput", "embed_size": 4,
                          "weights_path": path, "backbone_embed_size": 6}}
    port = _build_inputs(cfg, "cpu")
    jax_inputs = jax_build_inputs(cfg)
    jv = jax_inputs.init(jax.random.PRNGKey(0), {"image": images(8, 8)})
    got = sorted(flax_path(f"inputs.{name}") for name in flax_paths(port))
    assert got == sorted(f"inputs/{p}" for p in flatten(jax.device_get(jv["params"])))


def test_the_convolution_backward_in_batch_chunks(monkeypatch):
    """The backward's batch chunks (``COLS_BYTES``, one example a chunk
    here) give the gradients of one chunk, up to the order of the batch sum
    (``test_image_input_forward_and_gradients`` holds those to JAX's)."""
    from torecsys_tpu_torch.inputs import image as I

    x = images(15, 17)
    kw = dict(strides=(2, 2), kernel_sizes=(4, 4))
    jm = jax_tower(**kw)
    variables = jm.init(jax.random.PRNGKey(6), {"image": x})
    grads = []
    for cols_bytes in (I.COLS_BYTES, 1):
        monkeypatch.setattr(I, "COLS_BYTES", cols_bytes)
        tower = port_tower(variables, **kw).train()
        tower({"image": torch.from_numpy(x)}).square().sum().backward()
        grads.append({n: p.grad for n, p in tower.named_parameters()})
    for name, g in grads[0].items():
        if name.startswith("conv_") and name.endswith("bias"):
            continue  # before a training BatchNorm: gradient 0 but for noise
        assert_close(grads[1][name].numpy(), g.numpy(), rtol=1e-6, msg=name)


@pytest.mark.parametrize("shape,kernel,stride,padding", [
    ((3, 4, 9, 12), 3, 1, 1), ((2, 3, 15, 17), 4, 2, 0), ((2, 5, 8, 8), 2, 2, 0),
    ((1, 2, 7, 7), 3, 2, 1)])
def test_columns_are_unfolds(shape, kernel, stride, padding):
    """The backward's columns, one copy of a strided view, are
    ``F.unfold``'s to the bit, from a ``channels_last`` input."""
    import torch.nn.functional as F

    from torecsys_tpu_torch.inputs.image import columns

    x = torch.randn(*shape).to(memory_format=torch.channels_last)
    assert torch.equal(columns(x, kernel, stride, padding),
                       F.unfold(x, kernel, padding=padding, stride=stride))
