"""Dense optimizer registry (counterpart of ``torecsys_tpu/train/optimizers.py``).

``get_optimizer`` returns a factory ``params -> torch.optim.Optimizer``:
torch optimizers are built over their parameters, which the trainer knows
only once it has split the dense parameters from the embedding tables.

The registry has the JAX package's twelve names (case-insensitive):
adadelta, adagrad, adam, adamw, adamax, lamb, lars, lion, nadam, radam,
rmsprop and sgd.  Each takes optax's keyword names and optax's defaults
(which are not torch's: adamw's ``weight_decay`` is 1e-4, adagrad's
``initial_accumulator_value`` 0.1 and ``eps`` 1e-7 inside the square root,
rmsprop's ``decay`` 0.9 with ``eps`` inside the square root, lion's ``b2``
0.99 and ``weight_decay`` 1e-3, lamb's ``eps`` 1e-6, lars'
``trust_coefficient`` 1e-3 and ``momentum`` 0.9, radam's ``threshold`` 5),
and ``lr`` may come as ``learning_rate``.  The update is optax's:

* **adam** with ``b1``/``b2``/``eps`` only is ``torch.optim.Adam`` with
  ``foreach=False``: its update ``lr * (m / (1 - b1^t)) / (sqrt(v) /
  sqrt(1 - b2^t) + eps)`` is optax's ``lr * m_hat / (sqrt(v_hat) + eps)``
  with eps after the bias-corrected square root, so the two agree step for
  step up to float32 rounding.  **adamw** with ``b1``/``b2``/``eps``/
  ``weight_decay`` only is ``torch.optim.AdamW`` the same way: torch takes
  ``p * (1 - lr * wd) - lr * adam``, optax ``p - lr * (adam + wd * p)``,
  the same update in another rounding order.  Both are given a step
  pre-hook that hands a parameter without a gradient a zero one, as optax
  updates every leaf (its moments decay, its weight decays) where torch
  would skip it.  On the card each is built with
  ``capturable=True``, for the eager steps as for the steps captured in a
  CUDA graph (``train.steps.make_train_scan``), so both give the same bits:
  its step count is then a float32 tensor on the card and its bias
  correction ``1 - b**t`` is taken in float32, as optax takes it.  On the
  CPU it is ``capturable=False`` (torch takes no CPU parameters there), and
  the bias correction is taken in float64.
* **The other ten** (and adam or adamw with ``nesterov``, ``eps_root`` or
  a mask) have no ``torch.optim`` class with optax's update: torch has no
  LAMB, LARS or Lion, and no Nesterov or ``eps_root`` form of Adam; its
  NAdam follows a momentum-decay schedule where optax's is Nesterov Adam;
  its Adamax adds ``eps`` to the infinity norm's other side; its Adagrad
  starts its accumulator at 0 and adds ``eps`` outside the square root;
  its RMSprop decays by 0.99 and adds ``eps`` outside.  Each is written out
  here as a
  :class:`OptaxOptimizer` that follows optax's chain step by step:
  ``scale_by_*``, then ``add_decayed_weights``, then the trust ratio, then
  ``scale_by_learning_rate`` (then lars' and rmsprop's momentum ``trace``),
  in optax's order of operations, with bias corrections taken in float32
  from a float32 step count on the parameters' device.

A step of these reads nothing back to the host (RAdam's threshold and the
trust ratios' zero norms are ``torch.where``), so it can be captured in a
CUDA graph.  Their state is made when the optimizer is built, as optax's
``init`` makes it, in each parameter's dtype (a bf16 table keeps bf16
slots), under optax's names (``mu``, ``nu``, ``sum_of_squares``,
``trace``, ``e_g``, ``e_x``), with ``step`` (optax's ``count``) where the
chain keeps a count.  A parameter without a gradient is updated with a zero
gradient, as an optax leaf is.

Not ported (ROADMAP queue 1: The small API remainder): optax's other names, which the JAX
package reaches by attribute; a schedule as ``learning_rate``; masks other
than None or True; ``mu_dtype`` and ``accumulator_dtype``.  They raise
``NotImplementedError``; a keyword optax does not take raises ``TypeError``.
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, Callable, Dict, Iterable, Optional

import torch

Factory = Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]
_TODO = "ROADMAP queue 1: The small API remainder (the optimizer remainder)"


def _norm(x: torch.Tensor) -> torch.Tensor:
    """optax's ``safe_norm(x, 0.0)``: ``sqrt(sum(x * x))`` over every
    element (0 for a zero tensor)."""
    return torch.sqrt(torch.sum(x * x))


def _bias_correction(decay: float, count: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """optax's ``1 - decay**count`` in float32, cast to ``like``'s dtype."""
    return (1 - torch.pow(decay, count)).to(like.dtype)


def _moment(g: torch.Tensor, t: torch.Tensor, decay: float, order: int) -> torch.Tensor:
    """optax's ``update_moment``: ``(1 - decay) * g**order + decay * t``."""
    return (1 - decay) * (g * g if order == 2 else g) + decay * t


def _trace(u: torch.Tensor, state: Dict, decay: float, nesterov: bool) -> torch.Tensor:
    """optax's ``trace``: ``t = u + decay * t``; the update ``t``, or
    ``u + decay * t`` with Nesterov momentum."""
    t = u + decay * state["trace"]
    state["trace"].copy_(t)
    return u + decay * t if nesterov else t


class OptaxOptimizer(torch.optim.Optimizer):
    """Base of the optimizers written out from optax's chains.

    A subclass names its slots and their initial values
    (:meth:`_slot_inits`), whether its chain keeps a count
    (:meth:`_has_count`), and the update before the learning rate
    (:meth:`_direction`); the base adds the learning rate's ``* -lr``
    (none when ``lr`` is None, as optax's ``scale_by_learning_rate(None)``
    is the identity), the optional momentum ``trace`` after it
    (:meth:`_after_lr`) and ``p + u``.
    """

    def __init__(self, params, lr: Optional[float], **hyper: Any):
        # "capturable": the step count lives on the parameter's device, and
        # load_state_dict keeps it there, as for a capturable torch optimizer
        super().__init__(params, dict(lr=lr, capturable=True, **hyper))
        for group in self.param_groups:
            for p in group["params"]:
                state = {name: torch.full_like(p, value, memory_format=torch.preserve_format)
                         for name, value in self._slot_inits(group).items()}
                if self._has_count(group):
                    state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                self.state[p] = state

    def _slot_inits(self, group) -> Dict[str, float]:
        return {}

    def _has_count(self, group) -> bool:
        return False

    def _direction(self, p: torch.Tensor, g: torch.Tensor, state: Dict, group) -> torch.Tensor:
        raise NotImplementedError

    def _after_lr(self, u: torch.Tensor, state: Dict, group) -> torch.Tensor:
        return u

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                state = self.state[p]
                if "step" in state:
                    state["step"] += 1
                u = self._direction(p, g, state, group)
                if group["lr"] is not None:
                    u = u * -group["lr"]
                p.add_(self._after_lr(u, state, group))
        return loss


class _AdamFamily(OptaxOptimizer):
    """optax's ``scale_by_adam`` (``mu``, ``nu``, ``step``), optionally
    Nesterov's, then ``add_decayed_weights``."""

    def _slot_inits(self, group):
        return {"mu": 0.0, "nu": 0.0}

    def _has_count(self, group):
        return True

    def _moments_hat(self, g, state, group):
        """``mu`` and ``nu`` moved by ``g`` and bias-corrected: ``(mu_hat,
        nu_hat)``, Nesterov's ``mu_hat`` with ``nesterov``."""
        b1, b2 = group["b1"], group["b2"]
        mu = _moment(g, state["mu"], b1, 1)
        nu = _moment(g, state["nu"], b2, 2)
        state["mu"].copy_(mu)
        state["nu"].copy_(nu)
        count = state["step"]
        if group["nesterov"]:
            mu_hat = (b1 * (mu / _bias_correction(b1, count + 1, mu))
                      + (1 - b1) * (g / _bias_correction(b1, count, g)))
        else:
            mu_hat = mu / _bias_correction(b1, count, mu)
        return mu_hat, nu / _bias_correction(b2, count, nu)

    def _direction(self, p, g, state, group):
        mu_hat, nu_hat = self._moments_hat(g, state, group)
        u = mu_hat / (torch.sqrt(nu_hat + group["eps_root"]) + group["eps"])
        wd = group.get("weight_decay", 0.0)
        return u + wd * p if wd else u


class Adam(_AdamFamily):
    """optax ``adam`` (the written-out form: for ``nesterov`` or
    ``eps_root``; plain Adam is ``torch.optim.Adam``)."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                 mu_dtype=None, *, nesterov=False):
        _no_dtype("mu_dtype", mu_dtype)
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root,
                         nesterov=nesterov)


class AdamW(_AdamFamily):
    """optax ``adamw``: ``scale_by_adam``, ``+ weight_decay * p``, ``* -lr``
    (the written-out form: for ``nesterov``, ``eps_root`` or a mask; plain
    AdamW is ``torch.optim.AdamW``)."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                 mu_dtype=None, weight_decay=1e-4, mask=None, *, nesterov=False):
        _no_dtype("mu_dtype", mu_dtype)
        _no_mask("mask", mask)
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root,
                         weight_decay=weight_decay, nesterov=nesterov)


class NAdam(Adam):
    """optax ``nadam``: ``adam`` with ``nesterov=True`` (Dozat 2016), not
    torch's momentum-decay NAdam."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                 mu_dtype=None, *, nesterov=True):
        super().__init__(params, lr, b1, b2, eps, eps_root, mu_dtype, nesterov=nesterov)


class RAdam(_AdamFamily):
    """optax ``radam``: the rectified update where ``ro >= threshold``, the
    bias-corrected momentum elsewhere (``torch.where``, no host branch)."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                 threshold=5.0, *, nesterov=False):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root,
                         threshold=threshold, nesterov=nesterov)

    def _direction(self, p, g, state, group):
        mu_hat, nu_hat = self._moments_hat(g, state, group)
        b2, count = group["b2"], state["step"]
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = torch.pow(b2, count)
        ro = ro_inf - 2 * count * b2t / (1 - b2t)
        r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        rect = r.to(mu_hat.dtype) * mu_hat / (torch.sqrt(nu_hat + group["eps_root"])
                                              + group["eps"])
        return torch.where(ro >= group["threshold"], rect, mu_hat)


class Adamax(OptaxOptimizer):
    """optax ``adamax``: ``nu = max(|g| + eps, b2 * nu)``, the update
    ``m_hat / nu``."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps)

    def _slot_inits(self, group):
        return {"mu": 0.0, "nu": 0.0}

    def _has_count(self, group):
        return True

    def _direction(self, p, g, state, group):
        mu = _moment(g, state["mu"], group["b1"], 1)
        nu = torch.maximum(torch.abs(g) + group["eps"], group["b2"] * state["nu"])
        state["mu"].copy_(mu)
        state["nu"].copy_(nu)
        return mu / _bias_correction(group["b1"], state["step"], mu) / nu


class Lamb(_AdamFamily):
    """optax ``lamb``: ``scale_by_adam``, ``+ weight_decay * p``, then the
    trust ratio ``||p|| / ||u||`` (1 where either norm is 0), ``* -lr``.
    The norms are over the stored tensor, a packed table's padding rows
    included, as over the JAX package's leaf of the same layout."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0,
                 weight_decay=0.0, mask=None):
        _no_mask("mask", mask)
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root,
                         weight_decay=weight_decay, nesterov=False)

    def _direction(self, p, g, state, group):
        return _trust_ratio(super()._direction(p, g, state, group), p, 1.0, 0.0)


def _trust_ratio(u: torch.Tensor, p: torch.Tensor, coefficient: float,
                 eps: float) -> torch.Tensor:
    """optax's ``scale_by_trust_ratio`` (``min_norm`` 0)."""
    param_norm, update_norm = _norm(p), _norm(u)
    ratio = coefficient * param_norm / (update_norm + eps)
    zero = torch.logical_or(param_norm == 0.0, update_norm == 0.0)
    return u * torch.where(zero, torch.ones((), dtype=p.dtype, device=p.device), ratio)


class Lars(OptaxOptimizer):
    """optax ``lars``: ``+ weight_decay * p``, the trust ratio
    ``trust_coefficient * ||p|| / (||u|| + eps)``, ``* -lr``, then the
    momentum ``trace``."""

    def __init__(self, params, lr=1e-3, weight_decay=0.0, weight_decay_mask=True,
                 trust_coefficient=0.001, eps=0.0, trust_ratio_mask=True, momentum=0.9,
                 nesterov=False):
        _no_mask("weight_decay_mask", weight_decay_mask)
        _no_mask("trust_ratio_mask", trust_ratio_mask)
        super().__init__(params, lr, weight_decay=weight_decay,
                         trust_coefficient=trust_coefficient, eps=eps, momentum=momentum,
                         nesterov=nesterov)

    def _slot_inits(self, group):
        return {"trace": 0.0}

    def _direction(self, p, g, state, group):
        u = g + group["weight_decay"] * p
        return _trust_ratio(u, p, group["trust_coefficient"], group["eps"])

    def _after_lr(self, u, state, group):
        return _trace(u, state, group["momentum"], group["nesterov"])


class Lion(OptaxOptimizer):
    """optax ``lion``: ``sign((1 - b1) * g + b1 * mu)`` (``sign(0) = 0``),
    ``mu`` moved by ``b2``, ``+ weight_decay * p``, ``* -lr``."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.99, mu_dtype=None, weight_decay=1e-3,
                 mask=None):
        _no_dtype("mu_dtype", mu_dtype)
        _no_mask("mask", mask)
        super().__init__(params, lr, b1=b1, b2=b2, weight_decay=weight_decay)

    def _slot_inits(self, group):
        return {"mu": 0.0}

    def _has_count(self, group):
        return True

    def _direction(self, p, g, state, group):
        u = torch.sign((1.0 - group["b1"]) * g + group["b1"] * state["mu"])
        state["mu"].copy_(_moment(g, state["mu"], group["b2"], 1))
        return u + group["weight_decay"] * p


class Adagrad(OptaxOptimizer):
    """optax ``adagrad`` (``scale_by_rss``): ``sum_of_squares += g**2``, the
    update ``g * where(sum_of_squares > 0, rsqrt(sum_of_squares + eps), 0)``."""

    def __init__(self, params, lr=1e-3, initial_accumulator_value=0.1, eps=1e-7):
        super().__init__(params, lr, initial_accumulator_value=initial_accumulator_value,
                         eps=eps)

    def _slot_inits(self, group):
        return {"sum_of_squares": group["initial_accumulator_value"]}

    def _direction(self, p, g, state, group):
        sos = g * g + state["sum_of_squares"]
        state["sum_of_squares"].copy_(sos)
        inv = torch.where(sos > 0, torch.rsqrt(sos + group["eps"]), torch.zeros_like(sos))
        return inv * g


class RMSprop(OptaxOptimizer):
    """optax ``rmsprop``: ``scale_by_rms`` (``nu``), or ``scale_by_stddev``
    (``mu`` and ``nu``) when ``centered``, bias-corrected with a count when
    ``bias_correction``; ``eps`` inside the square root when ``eps_in_sqrt``;
    ``* -lr``; then the momentum ``trace`` when ``momentum`` is set."""

    def __init__(self, params, lr=1e-3, decay=0.9, eps=1e-8, initial_scale=0.0,
                 eps_in_sqrt=True, centered=False, momentum=None, nesterov=False,
                 bias_correction=False):
        super().__init__(params, lr, decay=decay, eps=eps, initial_scale=initial_scale,
                         eps_in_sqrt=eps_in_sqrt, centered=centered, momentum=momentum,
                         nesterov=nesterov, bias_correction=bias_correction)

    def _slot_inits(self, group):
        slots = {"nu": group["initial_scale"]}
        if group["centered"]:
            slots = {"mu": 0.0, **slots}
        if group["momentum"] is not None:
            slots["trace"] = 0.0
        return slots

    def _has_count(self, group):
        return group["bias_correction"]

    def _direction(self, p, g, state, group):
        decay, eps = group["decay"], group["eps"]
        nu = _moment(g, state["nu"], decay, 2)
        state["nu"].copy_(nu)
        mu = None
        if group["centered"]:
            mu = _moment(g, state["mu"], decay, 1)
            state["mu"].copy_(mu)
        if group["bias_correction"]:
            nu = nu / _bias_correction(decay, state["step"], nu)
            if mu is not None:
                mu = mu / _bias_correction(decay, state["step"], mu)
        if mu is not None:
            nu = nu - mu * mu
        scaling = torch.rsqrt(nu + eps) if group["eps_in_sqrt"] else 1 / (torch.sqrt(nu) + eps)
        return scaling * g

    def _after_lr(self, u, state, group):
        if group["momentum"] is None:
            return u
        return _trace(u, state, group["momentum"], group["nesterov"])


class SGD(OptaxOptimizer):
    """optax ``sgd``: the momentum ``trace`` of the gradient when
    ``momentum`` is set, then ``* -lr``."""

    def __init__(self, params, lr=1e-3, momentum=None, nesterov=False, accumulator_dtype=None):
        _no_dtype("accumulator_dtype", accumulator_dtype)
        super().__init__(params, lr, momentum=momentum, nesterov=nesterov)

    def _slot_inits(self, group):
        return {} if group["momentum"] is None else {"trace": 0.0}

    def _direction(self, p, g, state, group):
        if group["momentum"] is None:
            return g
        return _trace(g, state, group["momentum"], group["nesterov"])


class Adadelta(OptaxOptimizer):
    """optax ``adadelta``: ``+ weight_decay * p``, then ``scale_by_adadelta``
    (``e_g``, ``e_x``), ``* -lr`` (none when ``lr`` is None, optax's
    default for it; the registry passes 1e-3)."""

    def __init__(self, params, lr=None, rho=0.9, eps=1e-6, weight_decay=0.0,
                 weight_decay_mask=None):
        _no_mask("weight_decay_mask", weight_decay_mask)
        super().__init__(params, lr, rho=rho, eps=eps, weight_decay=weight_decay)

    def _slot_inits(self, group):
        return {"e_g": 0.0, "e_x": 0.0}

    def _direction(self, p, g, state, group):
        rho, eps = group["rho"], group["eps"]
        u = g + group["weight_decay"] * p
        e_g = _moment(u, state["e_g"], rho, 2)
        u = torch.sqrt(state["e_x"] + eps) / torch.sqrt(e_g + eps) * u
        state["e_g"].copy_(e_g)
        state["e_x"].copy_(_moment(u, state["e_x"], rho, 2))
        return u


def _no_mask(name: str, mask) -> None:
    if mask is not None and mask is not True:
        raise NotImplementedError(f"{name}={mask!r}: only None or True (every parameter) is "
                                  f"ported; a mask is {_TODO}")


def _no_dtype(name: str, dtype) -> None:
    if dtype is not None:
        raise NotImplementedError(f"{name}={dtype!r} is not ported ({_TODO}); the state "
                                  "takes each parameter's dtype")


_OPTIMIZERS = {
    "adadelta": Adadelta,
    "adagrad": Adagrad,
    "adam": Adam,
    "adamw": AdamW,
    "adamax": Adamax,
    "lamb": Lamb,
    "lars": Lars,
    "lion": Lion,
    "nadam": NAdam,
    "radam": RAdam,
    "rmsprop": RMSprop,
    "sgd": SGD,
}
_TORCH_ADAM_KEYS = {"b1", "b2", "eps"}
_TORCH_KEYS = {"adam": _TORCH_ADAM_KEYS, "adamw": _TORCH_ADAM_KEYS | {"weight_decay"}}


def get_optimizer(name: str = "Adam", lr: Optional[float] = 1e-3, **kwargs: Any) -> Factory:
    """A dense optimizer factory ``params -> torch.optim.Optimizer`` from a
    (torch-style or optax) name: one of the twelve names, with optax's
    keyword names and defaults; ``lr`` may also be passed as
    ``learning_rate``.  Unknown names raise ``KeyError``, keywords optax
    does not take ``TypeError``, what is not ported ``NotImplementedError``."""
    lr = kwargs.pop("learning_rate", lr)
    key = name.lower()
    if key not in _OPTIMIZERS:
        raise KeyError(f"unknown optimizer {name!r}; available: {sorted(_OPTIMIZERS)} (optax's "
                       f"other names are {_TODO})")
    if callable(lr):
        raise NotImplementedError(f"a schedule as learning_rate is {_TODO}")
    cls = _OPTIMIZERS[key]
    inspect.signature(cls).bind(None, lr, **kwargs)  # TypeError for what optax does not take
    for k in ("mask", "weight_decay_mask", "trust_ratio_mask"):
        if k in kwargs:
            _no_mask(k, kwargs[k])
    for k in ("mu_dtype", "accumulator_dtype"):
        _no_dtype(k, kwargs.get(k))
    if key in _TORCH_KEYS and lr is not None and set(kwargs) <= _TORCH_KEYS[key]:
        torch_cls, extra = ((torch.optim.Adam, {}) if key == "adam" else
                            (torch.optim.AdamW, {"weight_decay": kwargs.get("weight_decay", 1e-4)}))
        return functools.partial(_torch_adam, torch_cls, lr=lr,
                                 betas=(kwargs.get("b1", 0.9), kwargs.get("b2", 0.999)),
                                 eps=kwargs.get("eps", 1e-8), **extra)
    return functools.partial(cls, lr=lr, **kwargs)


def _zero_missing_grads(opt: torch.optim.Optimizer, args, kwargs) -> None:
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def _torch_adam(torch_cls, params: Iterable[torch.nn.Parameter],
                **kwargs: Any) -> torch.optim.Adam:
    params = list(params)
    on_card = any(p.device.type == "cuda" for p in params)
    opt = torch_cls(params, foreach=False, capturable=on_card, **kwargs)
    opt.register_step_pre_hook(_zero_missing_grads)
    return opt


def available_optimizers() -> Dict[str, Any]:
    """``{name: optimizer class}`` of the twelve names (``adam``'s and
    ``adamw``'s are the written-out forms; ``get_optimizer`` builds
    ``torch.optim.Adam`` and ``torch.optim.AdamW`` for the plain ones)."""
    return dict(_OPTIMIZERS)


__all__ = ["Adadelta", "Adagrad", "Adam", "AdamW", "Adamax", "Lamb", "Lars", "Lion", "NAdam",
           "OptaxOptimizer", "RAdam", "RMSprop", "SGD", "available_optimizers",
           "get_optimizer"]
