"""The port's dense optimizer registry (``torecsys_tpu_torch/train/optimizers.py``)
against optax, name by name.

For each of the JAX registry's twelve names, at optax's defaults and at one
other setting (weight decay, momentum or Nesterov where the chain has one,
RMSprop centered): optax takes 3 steps on random float32 leaves (a flax
``kernel`` among them), its state is carried into the port through
``convert.from_flax_params``, and both take one more step on one gradient:
the parameters and every state tensor within atol 1e-7 + rtol 1e-6, and the
count.  ``torch.optim.Adam`` and ``torch.optim.AdamW`` (plain adam and
adamw) on the CPU take their bias correction in float64 where optax takes
it in float32 (``tests/test_torch_model.py``), which moves a step by up to
2e-5 of lr: their parameters are held at atol 1e-6.  Then 5 free steps of each from the same leaves within rtol 1e-5.
The optax update is jitted, as the JAX Trainer's step is: un-jitted, XLA
takes ``b2**count`` by another route, one ulp off, and RAdam's threshold
branch moves with it.  And the registry: names, aliases, refusals."""

import contextlib
import copy
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from torecsys_tpu_torch.convert import flatten, from_flax_params, optax_fields, torch_name
from torecsys_tpu_torch.ops import kernels
from torecsys_tpu_torch.ops.kernels import adam as adam_kernel
from torecsys_tpu_torch.train.optimizers import (
    MultiTensorAdam,
    MultiTensorAdamW,
    OptaxOptimizer,
    available_optimizers,
    get_optimizer,
)
from torecsys_tpu_torch.train.schedules import constant_schedule
from torecsys_tpu_torch.train.state import TrainState

LR = 1e-2
NAMES = ("adadelta", "adagrad", "adam", "adamw", "adamax", "lamb", "lars", "lion", "nadam",
         "radam", "rmsprop", "sgd")
# one setting besides the defaults for each name
OTHER = {
    "adadelta": {"weight_decay": 0.01},
    "adagrad": {"initial_accumulator_value": 0.0},  # where(sum_of_squares > 0, ...) at 0
    "adam": {"nesterov": True},
    "adamw": {"weight_decay": 0.1},
    "adamax": {"b1": 0.5},
    "lamb": {"weight_decay": 0.01},
    "lars": {"weight_decay": 0.01, "nesterov": True},
    "lion": {"weight_decay": 0.1},
    "nadam": {"nesterov": False},
    "radam": {"nesterov": True},
    "rmsprop": {"centered": True, "momentum": 0.9},
    "sgd": {"momentum": 0.9, "nesterov": True},
}
# the plain forms that get_optimizer builds as torch.optim classes
TORCH_ADAM = (torch.optim.Adam, torch.optim.AdamW)
CASES = ([(n, {}) for n in NAMES] + [(n, kw) for n, kw in OTHER.items()]
         + [("rmsprop", {"bias_correction": True, "eps_in_sqrt": False}),
            ("sgd", {"momentum": 0.9})])


class Tiny(nn.Module):
    """A Dense layer and a table, named as flax names them."""

    def __init__(self):
        super().__init__()
        self.dense = nn.Module()
        self.dense.weight = nn.Parameter(torch.zeros(3, 5))  # flax kernel (5, 3)
        self.dense.bias = nn.Parameter(torch.zeros(3))
        self.embedding = nn.Parameter(torch.zeros(6, 8))


def leaves(seed):
    rng = np.random.default_rng(seed)
    return {"dense": {"kernel": rng.normal(size=(5, 3)).astype(np.float32),
                      "bias": rng.normal(size=(3,)).astype(np.float32)},
            "embedding": rng.normal(size=(6, 8)).astype(np.float32)}


def grads(seed):
    g = leaves(seed)
    g["embedding"][2] = 0.0  # a row the batch does not touch
    return g


def jax_steps(tx, params, n, seed):
    update = jax.jit(tx.update)
    apply = jax.jit(optax.apply_updates)
    state = tx.init(params)
    for i in range(n):
        u, state = update(jax.tree.map(jnp.asarray, grads(seed + i)), state, params)
        params = apply(params, u)
    return params, state


def port_state(name, kwargs, params_np, opt_np):
    module = Tiny()
    state = TrainState.create(module, get_optimizer(name, lr=LR, **kwargs), None, None, "cpu")
    from_flax_params(module, params_np, opt_np, state)
    return module, state


def set_grads(module, g):
    named = dict(module.named_parameters())
    for path, v in flatten(g).items():
        arr = np.asarray(v)
        named[torch_name(path)].grad = torch.from_numpy(
            np.ascontiguousarray(arr.T if path.endswith("kernel") else arr))


def as_port(path, value):
    arr = np.asarray(value)
    return arr.T if path.endswith("kernel") else arr


@pytest.mark.parametrize("name,kwargs", CASES, ids=[f"{n}-{kw}" for n, kw in CASES])
def test_one_step_from_one_optax_state(name, kwargs):
    tx = getattr(optax, name)(learning_rate=LR, **kwargs)
    params, state = jax_steps(tx, jax.tree.map(jnp.asarray, leaves(0)), 3, seed=10)
    params_np, state_np = jax.device_get(params), jax.device_get(state)
    module, port = port_state(name, kwargs, params_np, state_np)
    opt = port.opt_state
    torch_adam = isinstance(opt, TORCH_ADAM)
    assert torch_adam == (name == "adam" and not kwargs
                          or name == "adamw" and set(kwargs) <= {"weight_decay"})
    fields = optax_fields(state_np)
    count = fields.pop("count", None)
    if count is not None:
        assert int(port.step) == int(count) == 3

    g = grads(99)
    upd, new_state = jax.jit(tx.update)(jax.tree.map(jnp.asarray, g), state, params)
    want = jax.device_get(optax.apply_updates(params, upd))
    set_grads(module, g)
    opt.step()
    named = dict(module.named_parameters())
    for path, ref in flatten(want).items():
        np.testing.assert_allclose(named[torch_name(path)].detach().numpy(), as_port(path, ref),
                                   rtol=1e-6, atol=1e-6 if torch_adam else 1e-7, err_msg=path)
    rename = {"mu": "exp_avg", "nu": "exp_avg_sq"} if torch_adam else {}
    new_fields = optax_fields(jax.device_get(new_state))
    new_count = new_fields.pop("count", None)
    for field, tree in new_fields.items():
        for path, ref in flatten(tree).items():
            got = opt.state[named[torch_name(path)]][rename.get(field, field)]
            np.testing.assert_allclose(got.numpy(), as_port(path, ref), rtol=1e-6, atol=1e-7,
                                       err_msg=f"{field} {path}")
    for p in named.values():
        assert set(opt.state[p]) - {"step"} == {rename.get(f, f) for f in new_fields}
        if new_count is not None:
            step = opt.state[p]["step"]
            assert step.dtype == torch.float32 and float(step) == int(new_count) == 4
        else:
            assert "step" not in opt.state[p]


@pytest.mark.parametrize("name,kwargs", CASES, ids=[f"{n}-{kw}" for n, kw in CASES])
def test_five_free_steps(name, kwargs):
    tx = getattr(optax, name)(learning_rate=LR, **kwargs)
    want, _ = jax_steps(tx, jax.tree.map(jnp.asarray, leaves(1)), 5, seed=20)
    module, port = port_state(name, kwargs, leaves(1), None)
    for i in range(5):
        set_grads(module, grads(20 + i))
        port.opt_state.step()
    torch_adam = isinstance(port.opt_state, TORCH_ADAM)
    named = dict(module.named_parameters())
    for path, ref in flatten(jax.device_get(want)).items():
        np.testing.assert_allclose(named[torch_name(path)].detach().numpy(), as_port(path, ref),
                                   rtol=1e-5, atol=1e-6 if torch_adam else 1e-7, err_msg=path)


def test_registry_names_aliases_and_refusals():
    assert sorted(available_optimizers()) == sorted(NAMES)
    p = nn.Parameter(torch.ones(2))
    assert type(get_optimizer("AdamW")([p])) is MultiTensorAdamW
    assert type(get_optimizer("Adam")([p])) is MultiTensorAdam
    assert isinstance(get_optimizer("AdamW")([p]), torch.optim.AdamW)
    assert isinstance(get_optimizer("AdamW", nesterov=True)([p]), OptaxOptimizer)
    assert get_optimizer("LaMb", learning_rate=0.5)([p]).defaults["lr"] == 0.5
    assert get_optimizer("Adam", learning_rate=0.25)([p]).defaults["lr"] == 0.25
    assert isinstance(get_optimizer("Adam", b1=0.8)([p]), torch.optim.Adam)
    assert isinstance(get_optimizer("Adam", nesterov=True)([p]), OptaxOptimizer)
    assert get_optimizer("AdamW")([p]).defaults["weight_decay"] == 1e-4  # optax's, not torch's
    assert get_optimizer("Lion")([p]).defaults["b2"] == 0.99
    with pytest.raises(KeyError, match="available"):
        get_optimizer("chain")
    with pytest.raises(TypeError):
        get_optimizer("SGD", betas=(0.9, 0.99))
    with pytest.raises(TypeError):
        get_optimizer("Adagrad", momentum=0.9)
    # ported since: optax's other names, a schedule, a mask, mu_dtype
    assert isinstance(get_optimizer("Adafactor")([p]), OptaxOptimizer)
    assert isinstance(get_optimizer("Adam", lr=constant_schedule(1e-3))([p]), OptaxOptimizer)
    assert callable(get_optimizer("AdamW", mask=lambda params: params))
    assert get_optimizer("Lion", mu_dtype=torch.bfloat16)([p]).state[p]["mu"].dtype == (
        torch.bfloat16)
    assert isinstance(get_optimizer("AdamW", mask=None)([p]), OptaxOptimizer)


@pytest.mark.parametrize("name", NAMES)
def test_state_keeps_a_bf16_parameters_dtype(name):
    """A bf16 table on the dense route keeps its optimizer state in bf16, as
    optax keeps a bf16 leaf's; the step count stays float32."""
    p = nn.Parameter(torch.ones(4, 8, dtype=torch.bfloat16))
    opt = get_optimizer(name, lr=LR, **OTHER[name])([p])
    p.grad = torch.full_like(p, 0.5)
    opt.step()
    state = opt.state[p]
    assert all(v.dtype == torch.bfloat16 for k, v in state.items() if k != "step")
    assert state.get("step", torch.zeros(())).dtype == torch.float32
    assert p.dtype == torch.bfloat16 and torch.isfinite(p.float()).all()


def test_a_parameter_without_a_gradient_takes_a_zero_one():
    """optax updates every leaf: Adam's moments decay and the parameter moves
    on a zero gradient; the port does the same, where ``torch.optim`` would
    skip the parameter."""
    tx = optax.adamw(LR)
    params = {"embedding": jnp.ones((6, 8))}
    state = tx.init(params)
    u, state = tx.update({"embedding": jnp.full((6, 8), 0.5)}, state, params)
    params = optax.apply_updates(params, u)
    u, state = tx.update({"embedding": jnp.zeros((6, 8))}, state, params)
    want = np.asarray(optax.apply_updates(params, u)["embedding"])
    p = nn.Parameter(torch.ones(6, 8))
    opt = get_optimizer("adamw", lr=LR)([p])
    p.grad = torch.full((6, 8), 0.5)
    opt.step()
    p.grad = None
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6, atol=1e-7)


# optax's other names, which the JAX get_optimizer reaches by attribute
# (torecsys_tpu/train/optimizers.py:38-43), at optax's defaults and at one
# other setting; noisy_sgd is held apart (its noise is replayed below)
OTHERS = [("adabelief", {}), ("adabelief", {"nesterov": True}), ("adafactor", {}),
          ("adafactor", {"min_dim_size_to_factor": 4, "momentum": 0.9,
                         "weight_decay_rate": 0.01, "clipping_threshold": 0.5}),
          ("adamaxw", {}), ("adamaxw", {"weight_decay": 0.1}), ("adan", {}),
          ("adan", {"weight_decay": 0.1}), ("amsgrad", {}), ("amsgrad", {"eps_root": 1e-8}),
          ("fromage", {}), ("fromage", {"min_norm": 10.0}), ("novograd", {}),
          ("novograd", {"weight_decay": 0.01}), ("optimistic_adam", {}),
          ("optimistic_adam", {"optimism": 0.05}), ("optimistic_adam_v2", {}),
          ("optimistic_adam_v2", {"alpha": 0.5, "beta": 2.0, "nesterov": False}),
          ("optimistic_gradient_descent", {}),
          ("optimistic_gradient_descent", {"alpha": 0.3, "beta": 0.7}), ("rprop", {}),
          ("rprop", {"eta_minus": 0.3, "max_step_size": 0.02}), ("sign_sgd", {}), ("sm3", {}),
          ("sm3", {"momentum": 0.5}), ("yogi", {}), ("yogi", {"b1": 0.5})]


def free_steps(name, kwargs, n=5):
    """``n`` steps of jitted optax (the JAX Trainer's ``tx.update(grads,
    opt_state, params)``) and of the port from the same leaves."""
    tx = getattr(optax, name)(learning_rate=LR, **kwargs)
    want, _ = jax_steps(tx, jax.tree.map(jnp.asarray, leaves(1)), n, seed=20)
    module, port = port_state(name, {k: _port_value(v) for k, v in kwargs.items()},
                              leaves(1), None)
    for i in range(n):
        set_grads(module, grads(20 + i))
        port.opt_state.step()
    return jax.device_get(want), dict(module.named_parameters()), port.opt_state


def _port_value(v):
    """A JAX dtype keyword as the port's (``mu_dtype=jnp.bfloat16``)."""
    return torch.bfloat16 if v is jnp.bfloat16 else v


def assert_leaves(want, named, rtol=1e-5, atol=1e-7):
    for path, ref in flatten(want).items():
        np.testing.assert_allclose(named[torch_name(path)].detach().float().numpy(),
                                   as_port(path, np.asarray(ref, np.float32)), rtol=rtol,
                                   atol=atol, err_msg=path)


@pytest.mark.parametrize("name,kwargs", OTHERS, ids=[f"{n}-{kw}" for n, kw in OTHERS])
def test_optax_others_five_free_steps(name, kwargs):
    with (pytest.warns(DeprecationWarning) if name == "optimistic_adam"
          else contextlib.nullcontext()):
        want, named, _ = free_steps(name, kwargs)
    assert_leaves(want, named)


def test_noisy_sgd_against_optax_replaying_the_ports_noise():
    """optax's ``noisy_sgd`` draws from a JAX key, whose bits cannot be had:
    the JAX side replays the port's noise (``gaussian_noise`` of the key, the
    count and the parameter's position) through optax's own formula, ``g +
    sqrt(eta / count**gamma) * noise``, then ``* -lr``; and the noise is
    standard normal."""
    from torecsys_tpu_torch.train.optimizers import gaussian_noise

    eta, gamma, key = 0.3, 0.55, 7
    module, port = port_state("noisy_sgd", {"eta": eta, "gamma": gamma, "key": key},
                              leaves(1), None)
    order = [torch_name(p) for p in flatten(leaves(1))]
    index = {n: i for i, n in enumerate(dict(module.named_parameters()))}
    params = jax.tree.map(jnp.asarray, leaves(1))
    for i in range(5):
        count = torch.tensor(float(i + 1))
        g = grads(20 + i)
        noise = {p: gaussian_noise(key, count, index[torch_name(p)],
                                   as_port(p, v).shape, "cpu").numpy()
                 for p, v in flatten(g).items()}
        std = jnp.sqrt(eta / jnp.int32(i + 1) ** gamma)
        flat_p = flatten(jax.device_get(params))
        params = {}
        for p, v in flatten(g).items():
            noisy = jnp.asarray(v) + std * jnp.asarray(as_port(p, noise[p]))
            params[p] = flat_p[p] + (-LR) * noisy
        from torecsys_tpu_torch.convert import unflatten
        params = unflatten(params)
        set_grads(module, g)
        port.opt_state.step()
    assert_leaves(jax.device_get(params), dict(module.named_parameters()), atol=1e-6)
    assert len(order) == 3
    z = gaussian_noise(1, torch.tensor(3.0), 0, (100_000,), "cpu")
    assert abs(z.mean().item()) < 0.01 and abs(z.std().item() - 1) < 0.01


@pytest.mark.parametrize("name,kwargs", [
    ("adamw", {"mask": {"dense": {"kernel": True, "bias": False}, "embedding": False}}),
    ("adamw", {"mask": lambda p: {"dense": {"kernel": True, "bias": False}, "embedding": True}}),
    ("lamb", {"weight_decay": 0.1, "mask": {"dense": True, "embedding": False}}),
    ("lion", {"mask": lambda p: jax.tree.map(lambda x: x.ndim > 1, p)}),
    ("adamaxw", {"mask": {"dense": False, "embedding": True}}),
    ("adan", {"weight_decay": 0.1, "mask": {"dense": {"kernel": False, "bias": True},
                                            "embedding": True}}),
    ("adadelta", {"weight_decay": 0.1, "weight_decay_mask": {"dense": True,
                                                             "embedding": False}}),
    ("lars", {"weight_decay": 0.1, "weight_decay_mask": {"dense": False, "embedding": True},
              "trust_ratio_mask": lambda p: {"dense": {"kernel": True, "bias": False},
                                             "embedding": True}}),
    ("adafactor", {"weight_decay_rate": 0.1, "weight_decay_mask": {"dense": True,
                                                                   "embedding": False}}),
    ("adamw", {"mask": False}),
], ids=lambda v: v if isinstance(v, str) else "")
def test_masks_against_optax(name, kwargs):
    """A mask (a pytree of bools, a prefix of one, or a callable over the
    parameters' tree; the port's callable sees its parameters as the nested
    dict of their flax paths) skips the masked-out leaves' weight decay or
    trust ratio, as ``optax.masked`` does."""
    tx = getattr(optax, name)(learning_rate=LR, **kwargs)
    want, _ = jax_steps(tx, jax.tree.map(jnp.asarray, leaves(1)), 5, seed=20)
    port_kwargs = {k: (_torch_mask(v) if callable(v) else v) for k, v in kwargs.items()}
    module, port = port_state(name, port_kwargs, leaves(1), None)
    for i in range(5):
        set_grads(module, grads(20 + i))
        port.opt_state.step()
    assert_leaves(jax.device_get(want), dict(module.named_parameters()))


def _torch_mask(fn):
    """The JAX test's callable over the port's tensors (``x.ndim`` is
    ``x.dim()`` there; jax.tree.map walks the nested dict)."""
    return lambda tree: fn(jax.tree.map(lambda t: np.empty(tuple(t.shape)), tree))


@pytest.mark.parametrize("name,kwargs", [
    ("adam", {"mu_dtype": jnp.bfloat16}), ("adamw", {"mu_dtype": jnp.bfloat16}),
    ("nadam", {"mu_dtype": jnp.bfloat16}), ("lion", {"mu_dtype": jnp.bfloat16}),
    ("amsgrad", {"mu_dtype": jnp.bfloat16}), ("optimistic_adam_v2", {"mu_dtype": jnp.bfloat16}),
    ("sgd", {"momentum": 0.9, "accumulator_dtype": jnp.bfloat16}),
    ("adafactor", {"momentum": 0.9, "dtype_momentum": jnp.bfloat16}),
], ids=lambda v: v if isinstance(v, str) else "")
def test_moment_dtypes_against_optax(name, kwargs):
    """``mu_dtype`` and ``accumulator_dtype``: the moment is stored in that
    dtype after its unrounded value made the update, as optax does."""
    want, named, opt = free_steps(name, kwargs)
    assert_leaves(want, named, rtol=1e-4, atol=1e-6)
    slot = {"sgd": "trace", "adafactor": "ema"}.get(name, "mu")
    assert all(s[slot].dtype == torch.bfloat16 for s in opt.state.values())


def test_names_the_jax_trainer_cannot_train_with_raise_as_there():
    """``polyak_sgd`` takes no ``learning_rate``: both registries raise
    ``TypeError`` at once.  ``lbfgs`` builds, and the first update raises
    ``TypeError`` on both sides (the Trainer's update passes no ``value``,
    ``grad`` or ``value_fn``).  Other optax attributes raise ``KeyError`` in
    the port, naming what it has."""
    from torecsys_tpu.train.optimizers import get_optimizer as jax_get_optimizer

    for get in (jax_get_optimizer, get_optimizer):
        with pytest.raises(TypeError, match="learning_rate"):
            get("polyak_sgd", lr=LR)
    tx = jax_get_optimizer("lbfgs", lr=LR)
    params = jax.tree.map(jnp.asarray, leaves(1))
    with pytest.raises(TypeError, match="value_fn"):
        jax.jit(tx.update)(jax.tree.map(jnp.asarray, grads(1)), tx.init(params), params)
    module, port = port_state("lbfgs", {}, leaves(1), None)
    set_grads(module, grads(1))
    with pytest.raises(TypeError, match="value_fn"):
        port.opt_state.step()
    with pytest.raises(KeyError, match="adabelief"):
        get_optimizer("scale_by_adam")
    with pytest.raises(TypeError):
        get_optimizer("yogi", nesterov=True)
    with pytest.raises(ValueError, match="schedules"):
        get_optimizer("optimistic_adam", lr=lambda c: c)([nn.Parameter(torch.ones(2))])


# ---- the multi-tensor Adam (ops/kernels/adam.py) ---------------------------
# On the CPU MultiTensorAdam and MultiTensorAdamW are torch's own step; on the
# card each group goes through adam_update, whose kernel follows its plain
# version, torch's capturable single-tensor step.  torch refuses CPU
# parameters under capturable=True, so these tests let the CPU through its
# device check (as tests/test_torch_model.py does) to run that arithmetic.
ADAM_FORMS = [("adam", {}, torch.optim.Adam), ("adamw", {"weight_decay": 0.1}, torch.optim.AdamW)]


@pytest.fixture
def capturable_on_cpu(monkeypatch):
    import torch.optim.adam as torch_adam

    supported = torch_adam._get_capturable_supported_devices
    monkeypatch.setattr(torch_adam, "_get_capturable_supported_devices",
                        lambda *a, **k: supported(*a, **k) + ["cpu"])


def adam_params(seed, shapes=((5, 3), (7,), (2, 2, 3))):
    gen = torch.Generator().manual_seed(seed)
    return [nn.Parameter(torch.randn(s, generator=gen)) for s in shapes]


def twin(params):
    return [nn.Parameter(p.detach().clone()) for p in params]


def step_both(ours, theirs, a, b, gen, skip=()):
    for i, (p, q) in enumerate(zip(a, b)):
        g = torch.randn(p.shape, generator=gen)
        p.grad = None if i in skip else g
        q.grad = torch.zeros_like(q) if i in skip else g.clone()
    ours.step()
    theirs.step()


def assert_same_state(ours, theirs, a, b):
    for p, q in zip(a, b):
        assert torch.equal(p, q)
        mine, torchs = ours.state[p], theirs.state[q]
        assert list(mine) == list(torchs) == ["step", "exp_avg", "exp_avg_sq"]
        for k in mine:
            assert mine[k].dtype == torchs[k].dtype and torch.equal(mine[k], torchs[k]), k


@pytest.mark.parametrize("name,kwargs,torch_cls", ADAM_FORMS, ids=[f[0] for f in ADAM_FORMS])
def test_multi_tensor_adam_on_the_cpu_is_torchs_step(name, kwargs, torch_cls):
    """20 steps of the registry's plain adam/adamw against torch's class from
    the same parameters and gradients: the same bits, state and keys."""
    a = adam_params(3)
    b = twin(a)
    ours = get_optimizer(name, lr=LR, **kwargs)(a)
    theirs = torch_cls(b, lr=LR, foreach=False, **kwargs)
    assert isinstance(ours, torch_cls) and ours.defaults["capturable"] is False
    gen = torch.Generator().manual_seed(4)
    for _ in range(20):
        step_both(ours, theirs, a, b, gen)
    assert_same_state(ours, theirs, a, b)


@pytest.mark.parametrize("name,kwargs,torch_cls", ADAM_FORMS, ids=[f[0] for f in ADAM_FORMS])
def test_multi_tensor_adam_state_dict_round_trips_through_torchs_class(name, kwargs, torch_cls):
    """The state_dict of the port's class loads into torch's and back: both
    then take the same steps to the bit."""
    a = adam_params(5)
    ours = get_optimizer(name, lr=LR, **kwargs)(a)
    gen = torch.Generator().manual_seed(6)
    for _ in range(3):
        for p in a:
            p.grad = torch.randn(p.shape, generator=gen)
        ours.step()
    b = twin(a)
    theirs = torch_cls(b, lr=LR, foreach=False, **kwargs)
    theirs.load_state_dict(copy.deepcopy(ours.state_dict()))
    c = twin(b)
    back = get_optimizer(name, lr=LR, **kwargs)(c)
    back.load_state_dict(copy.deepcopy(theirs.state_dict()))
    assert_same_state(back, theirs, c, b)
    for _ in range(3):
        step_both(back, theirs, c, b, gen)
    assert_same_state(back, theirs, c, b)


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_multi_tensor_adam_parameter_without_a_gradient_as_optax(name):
    """A parameter without a gradient at the second step is updated as optax
    updates a leaf with a zero gradient (its moments decay, it moves)."""
    tx = getattr(optax, name)(LR)
    params = {"embedding": jnp.ones((6, 8))}
    state = tx.init(params)
    for g in (jnp.full((6, 8), 0.5), jnp.zeros((6, 8))):
        u, state = tx.update({"embedding": g}, state, params)
        params = optax.apply_updates(params, u)
    p = nn.Parameter(torch.ones(6, 8))
    opt = get_optimizer(name, lr=LR)([p])
    p.grad = torch.full((6, 8), 0.5)
    opt.step()
    p.grad = None
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params["embedding"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(),
                               np.asarray(state[0].mu["embedding"]), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("weight_decay,decoupled", [(0.0, False), (0.1, False), (0.1, True)],
                         ids=["adam", "adam-l2", "adamw"])
def test_plain_adam_update_is_torchs_capturable_step(capturable_on_cpu, weight_decay, decoupled):
    """The kernel's specification, adam_update (the plain version on the
    CPU), against torch's capturable single-tensor Adam over 20 steps: the
    same bits for parameters, moments and float32 counts; a missing gradient
    as zeros."""
    torch_cls = torch.optim.AdamW if decoupled else torch.optim.Adam
    a = adam_params(7)
    b = twin(a)
    theirs = torch_cls(b, lr=LR, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay,
                       foreach=False, capturable=True)
    ms = [torch.zeros_like(p) for p in a]
    vs = [torch.zeros_like(p) for p in a]
    steps = [torch.zeros((), dtype=torch.float32) for _ in a]
    gen = torch.Generator().manual_seed(8)
    for i in range(20):
        gs = [None if (i % 5 == 4 and k == 1) else torch.randn(p.shape, generator=gen)
              for k, p in enumerate(a)]
        for q, g in zip(b, gs):
            q.grad = torch.zeros_like(q) if g is None else g.clone()
        with torch.no_grad():
            adam_kernel.adam_update(a, gs, ms, vs, steps, lr=LR, b1=0.9, b2=0.999, eps=1e-8,
                                    weight_decay=weight_decay, decoupled=decoupled)
        theirs.step()
    for p, q, m, v, t in zip(a, b, ms, vs, steps):
        state = theirs.state[q]
        assert torch.equal(p, q) and torch.equal(m, state["exp_avg"])
        assert torch.equal(v, state["exp_avg_sq"]) and torch.equal(t, state["step"])
        assert t.dtype == torch.float32 and float(t) == 20


@pytest.mark.parametrize("name,kwargs,torch_cls", ADAM_FORMS, ids=[f[0] for f in ADAM_FORMS])
def test_multi_tensor_adam_card_branch_steps_as_torchs_capturable_adam(
        monkeypatch, capturable_on_cpu, name, kwargs, torch_cls):
    """The step's card branch, with adam_update's plain version standing in
    for the kernel: one call a group with the group's tensors, a missing
    gradient passed as None (none allocated), torch's state keys and float32
    counts on the parameters' device; 20 steps equal torch's capturable Adam
    to the bit."""
    calls = []

    def recording(params, grads, *rest, **hyper):
        calls.append((len(params), [g is None for g in grads], hyper))
        adam_kernel.adam_update_plain(params, grads, *rest, **hyper)

    monkeypatch.setattr(kernels, "device_kind", lambda *tensors: "cuda")
    monkeypatch.setattr(adam_kernel, "adam_update", recording)
    a = adam_params(9)
    b = twin(a)
    ours = get_optimizer(name, lr=LR, **kwargs)(a)
    theirs = torch_cls(b, lr=LR, foreach=False, capturable=True, **kwargs)
    gen = torch.Generator().manual_seed(10)
    for i in range(20):
        step_both(ours, theirs, a, b, gen, skip=(2,) if i % 4 == 3 else ())
        assert a[2].grad is not None or i % 4 == 3
    assert_same_state(ours, theirs, a, b)
    assert len(calls) == 20 and all(n == 3 for n, _, _ in calls)
    assert calls[3][1] == [False, False, True]
    assert calls[0][2] == dict(lr=LR, b1=0.9, b2=0.999, eps=1e-8,
                               weight_decay=kwargs.get("weight_decay", 0.0),
                               decoupled=name == "adamw")


def test_adam_update_refuses_what_the_kernel_does_not_take():
    """A dtype other than float32, a non-contiguous tensor, a mix of devices,
    a count that is not one float32 element: ValueError."""
    p = torch.zeros(4, 4)

    def call(p=p, g=None, m=None, v=None, step=None):
        adam_kernel.adam_update([p], [g], [torch.zeros_like(p) if m is None else m],
                                [torch.zeros_like(p) if v is None else v],
                                [torch.zeros(()) if step is None else step],
                                lr=LR, b1=0.9, b2=0.999, eps=1e-8)

    call()
    for bad in (dict(p=p.bfloat16()), dict(g=torch.zeros(4, 4).t()),
                dict(m=torch.zeros(4, 4, device="meta")), dict(step=torch.zeros(2)),
                dict(step=torch.zeros((), dtype=torch.float64)), dict(v=torch.zeros(16))):
        with pytest.raises(ValueError):
            call(**bad)
    q = nn.Parameter(torch.zeros(3, device="meta"))
    with pytest.raises(ValueError):
        MultiTensorAdam([nn.Parameter(torch.zeros(3)), q]).step()


def test_adam_launch_plan_vector_path_and_split():
    """The argument packing, in pure Python: a tensor takes the 16-byte path
    where p, g, m and v all start on a 16-byte boundary (a missing gradient
    aside), ceil(numel / 4) units, its first unit in ``start``; the grid
    covers the units up to 8 blocks an SM; past MAX_TENSORS tensors the
    group splits into launches of at most MAX_TENSORS, in order."""
    base = 1 << 20
    entries = [
        (base, base + 512, base + 1024, base + 2048, base + 4096, 10),       # aligned, tail of 2
        (base + 4, base + 512, base + 1024, base + 2048, base + 4100, 8),    # p off by 4
        (base, 0, base + 1024, base + 2048, base + 4104, 4),                 # no gradient
        (base, base + 520, base + 1024, base + 2048, base + 4108, 0),        # empty, g off by 8
    ]
    hyper = adam_kernel.hyper_fields(1e-3, 0.9, 0.999, 1e-8, 1e-4, True)
    [(table, blocks)] = adam_kernel.plan_launches(entries, hyper, sms=132)
    assert table.n == 4 and blocks == 1
    assert list(table.vec[:4]) == [1, 0, 1, 0]
    assert list(table.start[:5]) == [0, 3, 5, 6, 6]
    assert list(table.numel[:4]) == [10, 8, 4, 0]
    assert table.g[2] is None and table.g[0] == base + 512 and table.step[3] == base + 4108
    assert table.decay == np.float32(1 - 1e-3 * 1e-4) and table.wd == 0.0
    assert table.w1 == np.float32(1 - 0.9) and table.c2 == np.float32(1 - 0.999)
    assert adam_kernel.hyper_fields(1e-3, 0.9, 0.999, 1e-8, 0.1, False)["wd"] == 0.1

    n = 2 * adam_kernel.MAX_TENSORS + 3
    big = [(base, base, base, base, base + 8 * i, 1 << 20 if i < n - 3 else 1001)
           for i in range(n)]
    plans = adam_kernel.plan_launches(big, hyper, sms=132)
    assert [t.n for t, _ in plans] == [adam_kernel.MAX_TENSORS, adam_kernel.MAX_TENSORS, 3]
    assert [b for _, b in plans] == [132 * adam_kernel.BLOCKS_PER_SM] * 2 + [3]  # 753 units
    assert plans[1][0].step[0] == base + 8 * adam_kernel.MAX_TENSORS
    assert list(plans[2][0].start[:4]) == [0, 251, 502, 753]
    assert ctypes.sizeof(adam_kernel.AdamTable) <= 4096
