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

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from torecsys_tpu_torch.convert import flatten, from_flax_params, optax_fields, torch_name
from torecsys_tpu_torch.train.optimizers import (
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
    assert type(get_optimizer("AdamW")([p])) is torch.optim.AdamW
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
