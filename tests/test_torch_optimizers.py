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
        get_optimizer("Adafactor")
    with pytest.raises(TypeError):
        get_optimizer("SGD", betas=(0.9, 0.99))
    with pytest.raises(TypeError):
        get_optimizer("Adagrad", momentum=0.9)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1: The small API remainder"):
        get_optimizer("Adam", lr=optax.constant_schedule(1e-3))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1: The small API remainder"):
        get_optimizer("AdamW", mask=lambda params: params)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1: The small API remainder"):
        get_optimizer("Lion", mu_dtype=jnp.bfloat16)
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
