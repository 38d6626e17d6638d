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

* **adam** with ``b1``/``b2``/``eps`` only is :class:`MultiTensorAdam`, a
  ``torch.optim.Adam`` with ``foreach=False``: its update ``lr * (m / (1 -
  b1^t)) / (sqrt(v) / sqrt(1 - b2^t) + eps)`` is optax's ``lr * m_hat /
  (sqrt(v_hat) + eps)`` with eps after the bias-corrected square root, so
  the two agree step for step up to float32 rounding.  **adamw** with
  ``b1``/``b2``/``eps``/``weight_decay`` only is :class:`MultiTensorAdamW`,
  a ``torch.optim.AdamW`` the same way: torch takes ``p * (1 - lr * wd) -
  lr * adam``, optax ``p - lr * (adam + wd * p)``, the same update in
  another rounding order.  A parameter without a gradient is updated with a
  zero one, as optax updates every leaf (its moments decay, its weight
  decays) where torch would skip it.  On the card each is built with
  ``capturable=True`` and steps a whole parameter group through one
  hand-written kernel (``ops.kernels.adam``: a count launch and one pass
  over every element, in the order of torch's capturable single-tensor
  step), for the eager steps as for the steps captured in a CUDA graph
  (``train.steps.make_train_scan``), so both give the same bits: its step
  count is a float32 tensor on the card and its bias correction ``1 -
  b**t`` is taken in float32, as optax takes it.  On the CPU it is torch's
  own single-tensor step with ``capturable=False`` (torch takes no CPU
  parameters there), and the bias correction is taken in float64.  Their
  state and ``state_dict`` are torch's (``step``, ``exp_avg``,
  ``exp_avg_sq``).
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

The JAX ``get_optimizer`` also reaches optax's other names by attribute.
Those its Trainer can train with (``tx.update(grads, opt_state, params)``)
are written out here the same way: adabelief, adafactor, adamaxw, adan,
amsgrad, fromage, noisy_sgd, novograd, optimistic_adam, optimistic_adam_v2,
optimistic_gradient_descent, rprop, sign_sgd, sm3 and yogi.  ``noisy_sgd``
draws its noise from a counter-based hash of its ``key``, the step count
and the position (:func:`gaussian_noise`), not from a JAX key.  ``lbfgs``
builds, and its step raises optax's ``TypeError`` (its line search needs
``value``, ``grad`` and ``value_fn``, which the Trainer's update does not
pass); ``polyak_sgd`` takes no ``learning_rate`` and raises ``TypeError``
here as there.  Any other name raises ``KeyError``.

``learning_rate`` may be a schedule (:mod:`torecsys_tpu_torch.train.schedules`),
evaluated at each update on a count the optimizer keeps on the parameters'
device (``lr_count``, optax's schedule count), so each replayed step of a
captured graph takes its own rate.  ``mask``, ``weight_decay_mask`` and
``trust_ratio_mask`` take a bool, a nested dict of bools over the flax
paths of the optimizer's parameters (a prefix holds for what is below it),
or a callable from the nested dict of those parameters to one; a
masked-out parameter skips the weight decay (or the trust ratio), as
``optax.masked`` passes its update through.  ``mu_dtype`` (and sgd's
``accumulator_dtype``, adafactor's ``dtype_momentum``) store the moment in
that dtype after the update used it unrounded, as optax does.  A keyword
optax does not take raises ``TypeError``.

On a row-sharded table (``parallel``: a rank holds its rows of the table as
the parameter), the Trainer hands the optimizer each such parameter's
:class:`~torecsys_tpu_torch.parallel.sharding.RowLayout` and the mesh
(:meth:`OptaxOptimizer.reduce_over`), and every quantity that optax takes
over the whole parameter is taken over the logical table, as the JAX
package's update, jitted over global arrays, takes it: the trust ratios'
norms (lamb, lars, fromage) and novograd's gradient norm are sums of squares
summed over the table group before the square root; sm3's accumulator
vectors of the other axes are maxima over the group (the row axis' own stays
local); adafactor decides to factor on the logical shape, and its means over
the row axis and its two root mean squares are sums over the group divided
by the logical counts; noisy_sgd draws each element's noise at its position
in the logical table.  The collectives are device ops (no host read), so a
step stays capturable in a CUDA graph over NCCL.  The optimizers that work
element by element take no collective.  :func:`state_row_axis` says which
state tensors hold rows of the table (the parameter's shape, adafactor's
factor along the rows, sm3's row vector) and which are reduced (replicated
on every rank), for checkpoints and ``convert``.
"""

from __future__ import annotations

import functools
import inspect
import math
import warnings
from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from torecsys_tpu_torch.ops import kernels as _kernels
from torecsys_tpu_torch.ops.kernels import adam as _adam_kernel

Factory = Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]


class TableGroup:
    """The reductions of a row-sharded parameter over its table group (the
    ranks holding the table's other rows), so that a norm, a mean or a
    maximum runs over the logical table.  ``axis`` is the parameter's row
    axis (0 of a ``(R, W)`` table, 1 of a field-aware ``(N, Vp, W)`` one),
    ``shape`` its logical shape and ``numel`` its logical element count."""

    def __init__(self, mesh, layout, local_shape):
        self.mesh, self.layout = mesh, layout
        self.axis = len(local_shape) - 2
        shape = list(local_shape)
        shape[self.axis] = layout.block_rows
        self.shape = tuple(shape)
        self.numel = math.prod(shape)

    def _reduce(self, ts, op: str):
        from torecsys_tpu_torch.parallel.mesh import TABLE_AXIS

        flat = torch.cat([t.reshape(-1) for t in ts])
        self.mesh.all_reduce(flat, TABLE_AXIS, op)
        return tuple(part.reshape(t.shape) for part, t in zip(
            flat.split([t.numel() for t in ts]), ts))

    def sum(self, *ts: torch.Tensor):
        """The group's sums of ``ts`` (of one dtype; one collective)."""
        return self._reduce(ts, "sum")

    def max(self, *ts: torch.Tensor):
        """The group's elementwise maxima of ``ts`` (of one dtype)."""
        return self._reduce(ts, "max")

    def positions(self, device) -> torch.Tensor:
        """The flat positions of the local elements in the logical tensor,
        in their local order (int64)."""
        width = self.shape[-1]
        rows = self.layout.global_rows().to(device)
        return (rows[:, None] * width + torch.arange(width, dtype=torch.int64,
                                                     device=device)).reshape(-1)


def _norm(x: torch.Tensor, table: Optional[TableGroup] = None) -> torch.Tensor:
    """optax's ``safe_norm(x, 0.0)``: ``sqrt(sum(x * x))`` over every
    element (0 for a zero tensor), of the logical table with ``table``."""
    sq = torch.sum(x * x)
    if table is not None:
        (sq,) = table.sum(sq)
    return torch.sqrt(sq)


def _mean(x: torch.Tensor, dim: int, table: Optional[TableGroup], row_axis: Optional[int],
          keepdim: bool = False) -> torch.Tensor:
    """``x.mean(dim)``; where ``x``'s axis ``row_axis`` indexes a sharded
    table's local rows and ``dim`` is that axis, the logical mean: the
    group's sum over the table's logical row count."""
    if table is None or dim != row_axis:
        return x.mean(dim=dim, keepdim=keepdim)
    (s,) = table.sum(x.sum(dim=dim, keepdim=keepdim))
    return s / table.shape[table.axis]


def _bias_correction(decay: float, count: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """optax's ``1 - decay**count`` in float32, cast to ``like``'s dtype."""
    return (1 - torch.pow(decay, count)).to(like.dtype)


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    return torch.tensor(value, dtype=dtype).item()


def _scaled(t: torch.Tensor, decay: float, g: torch.Tensor) -> torch.Tensor:
    """``decay * t``.  A moment stored narrower than ``g`` (``mu_dtype``) is
    scaled as jitted XLA scales it: by ``decay`` rounded to its dtype (JAX's
    weak type), the product not rounded before its wider consumer."""
    wide = torch.promote_types(t.dtype, g.dtype)
    if wide == t.dtype:
        return decay * t
    return t.to(wide) * _rounded(decay, t.dtype)


def _moment(g: torch.Tensor, t: torch.Tensor, decay: float, order: int) -> torch.Tensor:
    """optax's ``update_moment``: ``(1 - decay) * g**order + decay * t``."""
    return (1 - decay) * (g * g if order == 2 else g) + _scaled(t, decay, g)


def _trace(u: torch.Tensor, state: Dict, decay: float, nesterov: bool) -> torch.Tensor:
    """optax's ``trace``: ``t = u + decay * t``; the update ``t``, or
    ``u + decay * t`` with Nesterov momentum."""
    t = u + _scaled(state["trace"], decay, u)
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

    _scales_lr = True  # the base multiplies the direction by -lr

    def __init__(self, params, lr, **hyper: Any):
        # "capturable": the step count lives on the parameter's device, and
        # load_state_dict keeps it there, as for a capturable torch optimizer;
        # "decay_on" and "trust_on": a mask's groups (_MaskedFactory)
        defaults = dict(lr=lr, capturable=True, decay_on=True, trust_on=True)
        defaults.update(hyper)
        self._tables: Dict[torch.Tensor, TableGroup] = {}
        super().__init__(params, defaults)
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = self._init_state(p, group)

    def _init_state(self, p: torch.Tensor, group) -> Dict[str, torch.Tensor]:
        dtypes = self._slot_dtypes(group)
        state = {name: torch.full_like(p, value, dtype=dtypes.get(name, p.dtype),
                                       memory_format=torch.preserve_format)
                 for name, value in self._slot_inits(group).items()}
        state.update(self._extra_state(p, group))
        if self._has_count(group):
            state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
        if callable(group["lr"]):
            state["lr_count"] = torch.zeros((), dtype=torch.int32, device=p.device)
        return state

    def reduce_over(self, mesh, layouts: Mapping[torch.Tensor, Any]) -> None:
        """Take the whole-parameter reductions of each parameter of
        ``layouts`` (``{parameter: RowLayout}``: a row-sharded table's local
        rows) over its table group of ``mesh`` (:class:`TableGroup`), and
        build its state again (it was made for the local shape, before the
        optimizer knew the table's)."""
        for group in self.param_groups:
            for p in group["params"]:
                layout = layouts.get(p)
                if layout is not None and layout.sharded and layout.shards > 1:
                    self._tables[p] = TableGroup(mesh, layout, tuple(p.shape))
                    self.state[p] = self._init_state(p, group)

    def _table(self, p: torch.Tensor) -> Optional[TableGroup]:
        return self._tables.get(p)

    def _shape(self, p: torch.Tensor) -> tuple:
        """``p``'s logical shape: a row-sharded table's whole one."""
        table = self._table(p)
        return tuple(p.shape) if table is None else table.shape

    def _state_row_axis(self, p: torch.Tensor, key: str, value) -> Optional[int]:
        """The axis of ``p``'s state tensor ``key`` that indexes ``p``'s
        stored rows, None for a reduced one (:func:`state_row_axis`)."""
        return _same_shape_axis(p, value)

    def _slot_inits(self, group) -> Dict[str, float]:
        return {}

    def _slot_dtypes(self, group) -> Dict[str, torch.dtype]:
        """Slots stored in another dtype than the parameter's (``mu_dtype``)."""
        return {}

    def _extra_state(self, p: torch.Tensor, group) -> Dict[str, torch.Tensor]:
        """State tensors of other shapes than the parameter's."""
        return {}

    def _lr(self, group, state, like: torch.Tensor):
        """The learning rate of this update: ``lr``, or a schedule at the
        count, in ``like``'s dtype (the count then moves on)."""
        lr = group["lr"]
        if not callable(lr):
            return lr
        value = lr(state["lr_count"]).to(like.dtype)
        state["lr_count"] += 1
        return value

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
                if self._scales_lr and group["lr"] is not None:
                    u = u * -self._lr(group, state, u)
                p.add_(self._after_lr(u, state, group))
        return loss


def _same_shape_axis(p: torch.Tensor, value) -> Optional[int]:
    """A state tensor of the parameter's shape holds the table's rows on its
    row axis; any other is reduced."""
    if (isinstance(value, torch.Tensor) and p.dim() >= 2
            and tuple(value.shape) == tuple(p.shape)):
        return p.dim() - 2
    return None


def state_row_axis(opt: torch.optim.Optimizer, p: torch.Tensor, key: str,
                   value) -> Optional[int]:
    """Which axis of ``opt``'s state tensor ``key`` (``value``) of a table
    parameter ``p`` indexes the table's stored rows: that tensor is sharded
    with the table (the parameter's shape, adafactor's factor along the
    rows, sm3's row vector); None for a reduced tensor, the same on every
    rank (a count, novograd's ``nu``, adafactor's factor across the rows,
    sm3's other vectors).  A torch optimizer's state is read by its shape."""
    if isinstance(opt, OptaxOptimizer):
        return opt._state_row_axis(p, key, value)
    return _same_shape_axis(p, value)


def _dtype(dtype) -> Optional[torch.dtype]:
    """A ``mu_dtype``-style argument as a torch dtype (None: the parameter's):
    a torch dtype, or a name such as ``"bfloat16"`` (also a numpy or JAX
    dtype's name)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or getattr(dtype, "__name__", None) or str(dtype)
    resolved = getattr(torch, name, None)
    if not isinstance(resolved, torch.dtype):
        raise TypeError(f"not a dtype: {dtype!r}")
    return resolved


def _mask_flag(name: str, mask) -> bool:
    """A mask given to an optimizer class itself: None or True (every
    parameter) or False (none).  A tree or a callable over the parameters
    needs their flax paths: ``get_optimizer``'s factory resolves it into
    parameter groups."""
    if mask is None or mask is True or mask is False:
        return mask is not False
    raise TypeError(f"{name}={mask!r}: a mask over the parameters is resolved by "
                    "get_optimizer's factory, which knows their flax paths")


class _AdamFamily(OptaxOptimizer):
    """optax's ``scale_by_adam`` (``mu``, ``nu``, ``step``), optionally
    Nesterov's, then ``add_decayed_weights``."""

    def _slot_inits(self, group):
        return {"mu": 0.0, "nu": 0.0}

    def _slot_dtypes(self, group):
        return {"mu": group["mu_dtype"]} if group.get("mu_dtype") is not None else {}

    def _has_count(self, group):
        return True

    def _moments_hat(self, g, state, group):
        """``mu`` and ``nu`` moved by ``g`` and bias-corrected: ``(mu_hat,
        nu_hat)``, Nesterov's ``mu_hat`` with ``nesterov``.  ``mu`` is stored
        in ``mu_dtype`` after its unrounded value made ``mu_hat``."""
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
        return _decay(u, p, group)


def _decay(u: torch.Tensor, p: torch.Tensor, group, rate=None) -> torch.Tensor:
    """optax's ``add_decayed_weights``: ``u + weight_decay * p`` where the
    group is not masked out."""
    wd = group.get("weight_decay", 0.0) if rate is None else rate
    return u + wd * p if wd and group["decay_on"] else u


class Adam(_AdamFamily):
    """optax ``adam`` (the written-out form: for ``nesterov``, ``eps_root``,
    ``mu_dtype`` or a schedule; plain Adam is :class:`MultiTensorAdam`)."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                 mu_dtype=None, *, nesterov=False):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root,
                         mu_dtype=_dtype(mu_dtype), nesterov=nesterov)


class AdamW(_AdamFamily):
    """optax ``adamw``: ``scale_by_adam``, ``+ weight_decay * p``, ``* -lr``
    (the written-out form: for ``nesterov``, ``eps_root``, ``mu_dtype``, a
    mask or a schedule; plain AdamW is :class:`MultiTensorAdamW`)."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                 mu_dtype=None, weight_decay=1e-4, mask=None, *, nesterov=False):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root,
                         mu_dtype=_dtype(mu_dtype), weight_decay=weight_decay,
                         nesterov=nesterov, decay_on=_mask_flag("mask", mask))


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
        return _decay(mu / _bias_correction(group["b1"], state["step"], mu) / nu, p, group)


class AdamaxW(Adamax):
    """optax ``adamaxw``: ``scale_by_adamax``, ``+ weight_decay * p``, ``* -lr``."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4,
                 mask=None):
        OptaxOptimizer.__init__(self, params, lr, b1=b1, b2=b2, eps=eps,
                                weight_decay=weight_decay, decay_on=_mask_flag("mask", mask))


class Lamb(_AdamFamily):
    """optax ``lamb``: ``scale_by_adam``, ``+ weight_decay * p``, then the
    trust ratio ``||p|| / ||u||`` (1 where either norm is 0), ``* -lr``.
    The norms are over the stored tensor, a packed table's padding rows
    included, as over the JAX package's leaf of the same layout."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0,
                 weight_decay=0.0, mask=None):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root,
                         weight_decay=weight_decay, nesterov=False,
                         decay_on=_mask_flag("mask", mask))

    def _direction(self, p, g, state, group):
        return _trust_ratio(super()._direction(p, g, state, group), p, 1.0, 0.0,
                            table=self._table(p))


def _trust_ratio(u: torch.Tensor, p: torch.Tensor, coefficient: float,
                 eps: float, min_norm: float = 0.0,
                 table: Optional[TableGroup] = None) -> torch.Tensor:
    """optax's ``scale_by_trust_ratio``; with ``table`` the norms are the
    logical table's (one collective)."""
    sq = (torch.sum(p * p), torch.sum(u * u))
    if table is not None:
        sq = table.sum(*sq)
    param_norm, update_norm = (_at_least(torch.sqrt(s), min_norm) for s in sq)
    ratio = coefficient * param_norm / (update_norm + eps)
    zero = torch.logical_or(param_norm == 0.0, update_norm == 0.0)
    return u * torch.where(zero, torch.ones((), dtype=p.dtype, device=p.device), ratio)


def _at_least(norm: torch.Tensor, min_norm: float) -> torch.Tensor:
    """optax's ``safe_norm`` of a norm: ``min_norm`` where it is at most that."""
    return norm if min_norm == 0.0 else torch.where(norm <= min_norm, min_norm, norm)


class Lars(OptaxOptimizer):
    """optax ``lars``: ``+ weight_decay * p``, the trust ratio
    ``trust_coefficient * ||p|| / (||u|| + eps)``, ``* -lr``, then the
    momentum ``trace``."""

    def __init__(self, params, lr=1e-3, weight_decay=0.0, weight_decay_mask=True,
                 trust_coefficient=0.001, eps=0.0, trust_ratio_mask=True, momentum=0.9,
                 nesterov=False):
        super().__init__(params, lr, weight_decay=weight_decay,
                         trust_coefficient=trust_coefficient, eps=eps, momentum=momentum,
                         nesterov=nesterov,
                         decay_on=_mask_flag("weight_decay_mask", weight_decay_mask),
                         trust_on=_mask_flag("trust_ratio_mask", trust_ratio_mask))

    def _slot_inits(self, group):
        return {"trace": 0.0}

    def _direction(self, p, g, state, group):
        u = _decay(g, p, group)
        if not group["trust_on"]:
            return u
        return _trust_ratio(u, p, group["trust_coefficient"], group["eps"],
                            table=self._table(p))

    def _after_lr(self, u, state, group):
        return _trace(u, state, group["momentum"], group["nesterov"])


class Lion(OptaxOptimizer):
    """optax ``lion``: ``sign((1 - b1) * g + b1 * mu)`` (``sign(0) = 0``),
    ``mu`` moved by ``b2``, ``+ weight_decay * p``, ``* -lr``."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.99, mu_dtype=None, weight_decay=1e-3,
                 mask=None):
        super().__init__(params, lr, b1=b1, b2=b2, weight_decay=weight_decay,
                         mu_dtype=_dtype(mu_dtype), decay_on=_mask_flag("mask", mask))

    def _slot_inits(self, group):
        return {"mu": 0.0}

    def _slot_dtypes(self, group):
        return {"mu": group["mu_dtype"]} if group["mu_dtype"] is not None else {}

    def _has_count(self, group):
        return True

    def _direction(self, p, g, state, group):
        u = torch.sign((1.0 - group["b1"]) * g + _scaled(state["mu"], group["b1"], g))
        state["mu"].copy_(_moment(g, state["mu"], group["b2"], 1))
        return _decay(u, p, group)


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
    ``momentum`` is set (stored in ``accumulator_dtype``), then ``* -lr``."""

    def __init__(self, params, lr=1e-3, momentum=None, nesterov=False, accumulator_dtype=None):
        super().__init__(params, lr, momentum=momentum, nesterov=nesterov,
                         accumulator_dtype=_dtype(accumulator_dtype))

    def _slot_inits(self, group):
        return {} if group["momentum"] is None else {"trace": 0.0}

    def _slot_dtypes(self, group):
        dtype = group["accumulator_dtype"]
        return {"trace": dtype} if dtype is not None else {}

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
        super().__init__(params, lr, rho=rho, eps=eps, weight_decay=weight_decay,
                         decay_on=_mask_flag("weight_decay_mask", weight_decay_mask))

    def _slot_inits(self, group):
        return {"e_g": 0.0, "e_x": 0.0}

    def _direction(self, p, g, state, group):
        rho, eps = group["rho"], group["eps"]
        u = _decay(g, p, group)
        e_g = _moment(u, state["e_g"], rho, 2)
        u = torch.sqrt(state["e_x"] + eps) / torch.sqrt(e_g + eps) * u
        state["e_g"].copy_(e_g)
        state["e_x"].copy_(_moment(u, state["e_x"], rho, 2))
        return u


# ---- optax's other names, reached by attribute in the JAX package ----------

class AdaBelief(OptaxOptimizer):
    """optax ``adabelief``: ``mu`` moved by ``g``, ``nu`` by the squared
    prediction error ``(g - mu)**2`` plus ``eps_root``, bias-corrected
    (Nesterov's ``mu_hat`` with ``nesterov``), ``mu_hat / (sqrt(nu_hat) +
    eps)``, ``* -lr``."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-16, eps_root=1e-16, *,
                 nesterov=False):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root,
                         nesterov=nesterov)

    def _slot_inits(self, group):
        return {"mu": 0.0, "nu": 0.0}

    def _has_count(self, group):
        return True

    def _direction(self, p, g, state, group):
        b1, b2, count = group["b1"], group["b2"], state["step"]
        mu = _moment(g, state["mu"], b1, 1)
        nu = _moment(g - mu, state["nu"], b2, 2) + group["eps_root"]
        state["mu"].copy_(mu)
        state["nu"].copy_(nu)
        if group["nesterov"]:
            mu_hat = (b1 * (mu / _bias_correction(b1, count + 1, mu))
                      + (1 - b1) * (g / _bias_correction(b1, count, g)))
        else:
            mu_hat = mu / _bias_correction(b1, count, mu)
        return mu_hat / (torch.sqrt(nu / _bias_correction(b2, count, nu)) + group["eps"])


class AMSGrad(_AdamFamily):
    """optax ``amsgrad``: Adam's moments, ``nu_max = max(nu_max, nu_hat)``,
    ``mu_hat / (sqrt(nu_max + eps_root) + eps)``, ``* -lr``."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                 mu_dtype=None):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root,
                         mu_dtype=_dtype(mu_dtype), nesterov=False)

    def _slot_inits(self, group):
        return {"mu": 0.0, "nu": 0.0, "nu_max": 0.0}

    def _direction(self, p, g, state, group):
        mu_hat, nu_hat = self._moments_hat(g, state, group)
        nu_max = torch.maximum(state["nu_max"], nu_hat)
        state["nu_max"].copy_(nu_max)
        return mu_hat / (torch.sqrt(nu_max + group["eps_root"]) + group["eps"])


class Adan(OptaxOptimizer):
    """optax ``adan`` (Xie et al., Algorithm 1): ``m``, ``v`` (of the
    gradient's difference, 0 at the first step), ``n`` (of ``g + (1 - b2)
    diff`` squared), the last gradient ``g``, each bias-corrected; ``(m_hat +
    (1 - b2) v_hat) / (sqrt(n_hat + eps_root) + eps)``, ``+ weight_decay *
    p``, ``* -lr``."""

    def __init__(self, params, lr=1e-3, b1=0.98, b2=0.92, b3=0.99, eps=1e-8, eps_root=1e-8,
                 weight_decay=0.0, mask=None):
        super().__init__(params, lr, b1=b1, b2=b2, b3=b3, eps=eps, eps_root=eps_root,
                         weight_decay=weight_decay, decay_on=_mask_flag("mask", mask))

    def _slot_inits(self, group):
        return {"m": 0.0, "v": 0.0, "n": 0.0, "g": 0.0}

    def _has_count(self, group):
        return True

    def _direction(self, p, g, state, group):
        b1, b2, b3, t = group["b1"], group["b2"], group["b3"], state["step"]
        diff = torch.where(t == 1, torch.zeros_like(g), g - state["g"])
        m = _moment(g, state["m"], b1, 1)
        v = _moment(diff, state["v"], b2, 1)
        n = _moment(g + (1 - b2) * diff, state["n"], b3, 2)
        for name, value in (("m", m), ("v", v), ("n", n), ("g", g)):
            state[name].copy_(value)
        u = m / _bias_correction(b1, t, m) + (1 - b2) * (v / _bias_correction(b2, t, v))
        u = u / (torch.sqrt(n / _bias_correction(b3, t, n) + group["eps_root"]) + group["eps"])
        return _decay(u, p, group)


class Fromage(OptaxOptimizer):
    """optax ``fromage``: the trust ratio (``min_norm``), ``* -lr * mult``,
    then ``+ (mult - 1) * p`` with ``mult = 1 / sqrt(1 + lr**2)`` in
    float32 (of the scheduled rate under a schedule, where optax's decay
    keeps the rate at count 0)."""

    _scales_lr = False

    def __init__(self, params, lr=1e-3, min_norm=1e-6):
        super().__init__(params, lr, min_norm=min_norm)

    def _direction(self, p, g, state, group):
        u = _trust_ratio(g, p, 1.0, 0.0, group["min_norm"], self._table(p))
        lr = group["lr"]
        if callable(lr):
            rate = self._lr(group, state, torch.empty((), dtype=torch.float32))
            mult = 1 / torch.sqrt(1 + rate ** 2)
            # optax's add_decayed_weights never moves its schedule's count:
            # the decay takes the schedule at count 0 at every update
            rate0 = lr(torch.zeros_like(state["lr_count"]))
            return u * (-(mult * rate)).to(u.dtype) + (1 / torch.sqrt(1 + rate0 ** 2) - 1) * p
        mult = np.float32(1) / np.sqrt(np.float32(1 + lr ** 2))
        return u * float(-(np.float32(lr) * mult)) + float(mult - np.float32(1)) * p


def gaussian_noise(key: int, count: torch.Tensor, index: int, shape, device,
                   positions: Optional[torch.Tensor] = None,
                   total: Optional[int] = None) -> torch.Tensor:
    """Standard normal float32 noise of ``shape`` for parameter ``index`` at
    update ``count`` (a 0-d device tensor): Box-Muller over two uniforms from
    the miners' counter-based hash (``miners.fold_in``) of ``key``, ``count``,
    ``index`` and the position; the same on the CPU, the card and in graph
    replays, and a function of those alone.  The first uniform of the
    element at position ``i`` of a tensor of ``total`` elements hashes ``i``,
    its second ``total + i``.  ``positions`` (int64, one an element) draws
    the elements at those positions of a tensor of ``total`` elements (a
    shard's of the logical table's draw); by default all of them."""
    from torecsys_tpu_torch.miners import fold_in, seed_key

    n = math.prod(shape)
    if positions is None:
        positions, total = torch.arange(n, dtype=torch.int64, device=device), n
    k = fold_in(fold_in(seed_key(key), count.to(torch.int64)), index)
    bits = fold_in(k, torch.cat([positions, positions + total]))
    u1 = (bits[:n].double() + 0.5) / 2.0 ** 32
    u2 = bits[n:].double() / 2.0 ** 32
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    return z.float().reshape(shape)


class NoisySGD(OptaxOptimizer):
    """optax ``noisy_sgd``: ``g + sqrt(eta / count**gamma) * noise``, ``*
    -lr``.  The noise is :func:`gaussian_noise` of ``key`` (an int; None is
    0, with optax's warning), not a JAX key's draws."""

    def __init__(self, params, lr=1e-3, eta=0.01, gamma=0.55, key=None, *, seed=None):
        if seed is not None:
            warnings.warn('"seed" is deprecated and will be removed in optax 0.2.7, use "key".',
                          DeprecationWarning)
            if key is not None:
                raise ValueError("Only one of seed or key can be specified.")
            key = seed
        if key is None:
            warnings.warn("Specifying a key will be required in optax 0.2.7.")
            key = 0
        super().__init__(params, lr, eta=eta, gamma=gamma, key=int(key))
        self._index = {p: i for i, p in enumerate(
            p for group in self.param_groups for p in group["params"])}

    def _has_count(self, group):
        return True

    def _direction(self, p, g, state, group):
        count = state["step"]
        std = torch.sqrt(group["eta"] / count ** group["gamma"])
        table = self._table(p)
        noise = gaussian_noise(group["key"], count, self._index[p], tuple(g.shape), g.device,
                               *((table.positions(g.device), table.numel) if table else ()))
        return g + std.to(g.dtype) * noise.to(g.dtype)


class NovoGrad(OptaxOptimizer):
    """optax ``novograd``: a per-parameter scalar ``nu`` of ``||g||**2`` (its
    first value, then moved by ``b2``), ``mu = g / (sqrt(nu + eps_root) +
    eps) + weight_decay * p`` (then ``b1 * mu +`` that), ``* -lr``; the first
    step's branch is a ``torch.where``."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.25, eps=1e-6, eps_root=0.0,
                 weight_decay=0.0):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root,
                         weight_decay=weight_decay)

    def _slot_inits(self, group):
        return {"mu": 0.0}

    def _extra_state(self, p, group):
        return {"nu": torch.zeros((), dtype=p.dtype, device=p.device)}

    def _has_count(self, group):
        return True

    def _direction(self, p, g, state, group):
        first = state["step"] == 1
        sq = torch.square(_norm(g, self._table(p)))
        nu = torch.where(first, sq.to(state["nu"].dtype), _moment(sq, state["nu"], group["b2"], 1))
        u = g / (torch.sqrt(nu + group["eps_root"]) + group["eps"]) + group["weight_decay"] * p
        mu = torch.where(first, u, group["b1"] * state["mu"] + u)
        state["nu"].copy_(nu)
        state["mu"].copy_(mu)
        return mu


class _Optimistic:
    """optax's ``scale_by_optimistic_gradient``: ``(alpha + beta) * u - beta
    * previous`` (``previous = u`` at the first update); ``previous`` keeps
    the incoming ``u``."""

    @staticmethod
    def apply(u, state, alpha, beta):
        prev = torch.where(state["is_initial_step"], u, state["previous_gradient"])
        state["previous_gradient"].copy_(u)
        state["is_initial_step"].fill_(False)
        return (alpha + beta) * u - beta * prev

    @staticmethod
    def state(p):
        return {"previous_gradient": torch.zeros_like(p),
                "is_initial_step": torch.ones((), dtype=torch.bool, device=p.device)}


class OptimisticGradientDescent(OptaxOptimizer):
    """optax ``optimistic_gradient_descent``: the optimistic step, ``* -lr``."""

    def __init__(self, params, lr=1e-3, alpha=1.0, beta=1.0):
        super().__init__(params, lr, alpha=alpha, beta=beta)

    def _extra_state(self, p, group):
        return _Optimistic.state(p)

    def _direction(self, p, g, state, group):
        return _Optimistic.apply(g, state, group["alpha"], group["beta"])


class OptimisticAdamV2(_AdamFamily):
    """optax ``optimistic_adam_v2``: ``scale_by_adam`` (Nesterov by default),
    the optimistic step of it, ``* -lr``."""

    def __init__(self, params, lr=1e-3, *, alpha=1.0, beta=1.0, b1=0.9, b2=0.999, eps=1e-8,
                 eps_root=0.0, mu_dtype=None, nesterov=True):
        super().__init__(params, lr, alpha=alpha, beta=beta, b1=b1, b2=b2, eps=eps,
                         eps_root=eps_root, mu_dtype=_dtype(mu_dtype), nesterov=nesterov)

    def _extra_state(self, p, group):
        return _Optimistic.state(p)

    def _direction(self, p, g, state, group):
        return _Optimistic.apply(super()._direction(p, g, state, group), state,
                                 group["alpha"], group["beta"])


class OptimisticAdam(OptimisticAdamV2):
    """optax ``optimistic_adam`` (deprecated there): ``scale_by_adam``, the
    optimistic step with ``alpha = lr`` and ``beta = optimism`` (default
    lr), then ``* -1``."""

    def __init__(self, params, lr=1e-3, optimism=None, b1=0.9, b2=0.999, eps=1e-8,
                 eps_root=0.0, mu_dtype=None, *, nesterov=True):
        warnings.warn("`optimistic_adam` is deprecated, please use `optimistic_adam_v2` "
                      "instead.", category=DeprecationWarning)
        if callable(lr):
            raise ValueError("This version of `optimistic_adam` does not support learning "
                             "rate schedules but `optimistic_adam_v2` does.")
        super().__init__(params, 1.0, alpha=lr, beta=lr if optimism is None else optimism,
                         b1=b1, b2=b2, eps=eps, eps_root=eps_root, mu_dtype=mu_dtype,
                         nesterov=nesterov)


class Rprop(OptaxOptimizer):
    """optax ``rprop``: per-element step sizes grown by ``eta_plus`` where the
    gradient kept its sign and shrunk by ``eta_minus`` where it flipped,
    clipped to ``[min_step_size, max_step_size]``; optax's update is the
    previous ``step_size * sign(g)`` (0 where the sign flipped), ``* -1``."""

    _scales_lr = False

    def __init__(self, params, lr=1e-3, eta_minus=0.5, eta_plus=1.2, min_step_size=1e-6,
                 max_step_size=50.0):
        if callable(lr):
            raise TypeError("rprop takes a float learning_rate (its first step size), as "
                            "optax's does")
        super().__init__(params, lr, eta_minus=eta_minus, eta_plus=eta_plus,
                         min_step_size=min_step_size, max_step_size=max_step_size)

    def _extra_state(self, p, group):
        return {"step_sizes": torch.full_like(p, group["lr"]),
                "prev_updates": torch.zeros_like(p)}

    def _direction(self, p, g, state, group):
        prev = state["prev_updates"]
        sign = g * prev
        sizes = torch.where(sign == 0, state["step_sizes"], torch.clamp(
            state["step_sizes"] * torch.where(sign > 0, group["eta_plus"], group["eta_minus"]),
            group["min_step_size"], group["max_step_size"]))
        update = torch.where(sign < 0, torch.zeros_like(prev), prev)
        state["prev_updates"].copy_(torch.where(sign < 0, torch.zeros_like(g),
                                                sizes * torch.sign(g)))
        state["step_sizes"].copy_(sizes)
        return -update


class SignSGD(OptaxOptimizer):
    """optax ``sign_sgd``: ``sign(g)``, ``* -lr``."""

    def __init__(self, params, lr=1e-3):
        super().__init__(params, lr)

    def _direction(self, p, g, state, group):
        return torch.sign(g)


class SM3(OptaxOptimizer):
    """optax ``sm3`` (``scale_by_sm3`` with ``b1 = momentum``, ``b2 = 1``,
    eps 1e-8): one accumulator vector per axis (``mu_<axis>``); the
    element's accumulator ``g**2 + min`` over its axes' entries (a vector's
    own entry), ``g * rsqrt(accum + eps)`` (0 where it is 0) into the
    momentum ``nu``; each axis' vector keeps the max of ``accum`` over the
    other axes; ``nu * -lr``."""

    def __init__(self, params, lr=1e-3, momentum=0.9):
        if callable(lr):
            raise TypeError("sm3 takes a float learning_rate, as optax's does")
        super().__init__(params, lr, momentum=momentum)

    def _extra_state(self, p, group):
        state = {f"mu_{i}": torch.zeros(s, dtype=p.dtype, device=p.device)
                 for i, s in enumerate(p.shape)}
        state["nu"] = torch.zeros_like(p)
        return state

    def _state_row_axis(self, p, key, value):
        if key.startswith("mu_") and p.dim() >= 2:
            return 0 if int(key[3:]) == p.dim() - 2 else None
        return super()._state_row_axis(p, key, value)

    def _direction(self, p, g, state, group):
        nd = g.dim()
        vs = [state[f"mu_{i}"].reshape([1] * i + [-1] + [1] * (nd - i - 1)) for i in range(nd)]
        if nd < 2:
            accum = g * g + vs[0]
        else:
            accum = g * g + functools.reduce(torch.minimum, vs)
        up = g * torch.where(accum > 0, torch.rsqrt(accum + 1e-8), torch.zeros_like(accum))
        nu = _moment(up, state["nu"], group["momentum"], 1)
        state["nu"].copy_(nu)
        maxima = [accum.amax(dim=[d for d in range(nd) if d != i]) if nd > 1 else accum
                  for i in range(nd)]
        table = self._table(p)
        if table is not None:  # each other axis' vector: its maximum over every row
            across = [i for i in range(nd) if i != table.axis]
            for i, m in zip(across, table.max(*(maxima[i] for i in across))):
                maxima[i] = m
        for i, m in enumerate(maxima):
            state[f"mu_{i}"].copy_(m)
        return nu


class Yogi(OptaxOptimizer):
    """optax ``yogi`` (``scale_by_yogi``: moments from 1e-6, ``nu - (1 - b2)
    * sign(nu - g**2) * g**2``, eps_root 0), ``mu_hat / (sqrt(nu_hat) +
    eps)``, ``* -lr``."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-3):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps)

    def _slot_inits(self, group):
        return {"mu": 1e-6, "nu": 1e-6}

    def _has_count(self, group):
        return True

    def _direction(self, p, g, state, group):
        b1, b2, count = group["b1"], group["b2"], state["step"]
        mu = _moment(g, state["mu"], b1, 1)
        sq = g * g
        nu = state["nu"] - (1 - b2) * torch.sign(state["nu"] - sq) * sq
        state["mu"].copy_(mu)
        state["nu"].copy_(nu)
        return (mu / _bias_correction(b1, count, mu)) / (
            torch.sqrt(nu / _bias_correction(b2, count, nu) + 0.0) + group["eps"])


class Adafactor(OptaxOptimizer):
    """optax ``adafactor``: ``scale_by_factored_rms`` (a factored second
    moment ``v_row``/``v_col`` over the two largest axes where the second
    largest reaches ``min_dim_size_to_factor``, else ``v``; decay ``1 -
    (count + 1 - decay_offset)**-decay_rate``), ``clip_by_block_rms``,
    ``* lr``, ``* rms(p)`` (at least 1e-3), the momentum ``ema`` (stored in
    ``dtype_momentum``), ``+ weight_decay_rate * p``, ``* -1``."""

    _scales_lr = False

    def __init__(self, params, lr=None, min_dim_size_to_factor=128, decay_rate=0.8,
                 decay_offset=0, multiply_by_parameter_scale=True, clipping_threshold=1.0,
                 momentum=None, dtype_momentum=torch.float32, weight_decay_rate=None,
                 eps=1e-30, factored=True, weight_decay_mask=None):
        super().__init__(params, lr, min_dim_size_to_factor=min_dim_size_to_factor,
                         decay_rate=decay_rate, decay_offset=decay_offset,
                         multiply_by_parameter_scale=multiply_by_parameter_scale,
                         clipping_threshold=clipping_threshold, momentum=momentum,
                         dtype_momentum=_dtype(dtype_momentum),
                         weight_decay_rate=weight_decay_rate, eps=eps, factored=factored,
                         decay_on=_mask_flag("weight_decay_mask", weight_decay_mask))

    @staticmethod
    def _factored_dims(shape, group):
        if not group["factored"] or len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < group["min_dim_size_to_factor"]:
            return None
        return int(order[-2]), int(order[-1])

    def _has_count(self, group):
        return True

    def _extra_state(self, p, group):
        # factored as the logical shape is; the factors' sizes are the local ones
        dims = self._factored_dims(self._shape(p), group)
        one = torch.zeros(1, dtype=p.dtype, device=p.device)
        if dims is None:
            state = {"v_row": one, "v_col": one.clone(), "v": torch.zeros_like(p)}
        else:
            d1, d0 = dims
            shape = list(p.shape)
            state = {"v_row": torch.zeros(shape[:d0] + shape[d0 + 1:], dtype=p.dtype,
                                          device=p.device),
                     "v_col": torch.zeros(shape[:d1] + shape[d1 + 1:], dtype=p.dtype,
                                          device=p.device),
                     "v": one}
        if group["momentum"] is not None:
            state["ema"] = torch.zeros_like(p, dtype=group["dtype_momentum"] or p.dtype)
        return state

    def _factor_row_axes(self, p, group):
        """``(v_row's, v_col's)`` axis along a sharded table's rows (None:
        the factor is a mean over the rows), or None unfactored."""
        dims = self._factored_dims(self._shape(p), group)
        if dims is None:
            return None
        axis = p.dim() - 2

        def kept(gone):  # the row axis once axis ``gone`` is reduced away
            return None if gone == axis else axis - (gone < axis)

        d1, d0 = dims
        return kept(d0), kept(d1)

    def _state_row_axis(self, p, key, value):
        if key in ("v_row", "v_col") and p.dim() >= 2:
            axes = self._factor_row_axes(p, self._group_of(p))
            return None if axes is None else axes[key == "v_col"]
        return super()._state_row_axis(p, key, value)

    def _group_of(self, p):
        return next(g for g in self.param_groups if any(q is p for q in g["params"]))

    def _direction(self, p, g, state, group):
        count = state["step"] - 1  # optax's count before this update
        t = count - group["decay_offset"] + 1
        rate = 1.0 - torch.pow(t, -group["decay_rate"])
        table = self._table(p)
        dims = self._factored_dims(self._shape(p), group)
        sq = g * g + group["eps"]
        if dims is None:
            v = rate * state["v"] + (1.0 - rate) * sq
            state["v"].copy_(v)
            u = g * torch.pow(state["v"], -0.5)
        else:
            d1, d0 = dims
            axis = None if table is None else table.axis
            row_axis = None if table is None else self._factor_row_axes(p, group)[0]
            v_row = rate * state["v_row"] + (1.0 - rate) * _mean(sq, d0, table, axis)
            v_col = rate * state["v_col"] + (1.0 - rate) * _mean(sq, d1, table, axis)
            state["v_row"].copy_(v_row)
            state["v_col"].copy_(v_col)
            v_row, v_col = state["v_row"], state["v_col"]
            reduced = d1 - 1 if d1 > d0 else d1
            row_factor = torch.pow(v_row / _mean(v_row, reduced, table, row_axis, keepdim=True),
                                   -0.5)
            u = g * row_factor.unsqueeze(d0) * torch.pow(v_col, -0.5).unsqueeze(d1)
        threshold = group["clipping_threshold"]
        scale = group["multiply_by_parameter_scale"]
        if table is None:
            mean_sq = (torch.mean(u * u) if threshold is not None else None,
                       torch.mean(p * p) if scale else None)
        else:  # the logical table's root mean squares (one collective)
            sums = table.sum(torch.sum(u * u), torch.sum(p * p))
            mean_sq = tuple(s / table.numel for s in sums)
        if threshold is not None:
            u = u / torch.clamp_min(torch.sqrt(mean_sq[0]) / threshold, 1.0)
        if group["lr"] is not None:
            u = u * self._lr(group, state, u)
        if scale:
            rms = torch.sqrt(mean_sq[1])
            u = u * torch.where(rms <= 1e-3, torch.full_like(rms, 1e-3), rms)
        if group["momentum"] is not None:
            ema = _moment(u, state["ema"], group["momentum"], 1)
            state["ema"].copy_(ema)
            u = ema
        if group["weight_decay_rate"] is not None:
            u = _decay(u, p, group, group["weight_decay_rate"])
        return -u


class LBFGS(OptaxOptimizer):
    """optax ``lbfgs`` as the JAX Trainer meets it: it builds, and its first
    update raises optax's ``TypeError``, as the Trainer's ``tx.update(grads,
    opt_state, params)`` gives its zoom line search no ``value``, ``grad``
    or ``value_fn``."""

    def __init__(self, params, lr=None, memory_size=10, scale_init_precond=True,
                 linesearch="zoom"):
        super().__init__(params, lr, memory_size=memory_size,
                         scale_init_precond=scale_init_precond, linesearch=linesearch)

    def step(self, closure=None):
        raise TypeError("scale_by_zoom_linesearch.<locals>.update_fn() missing 3 required "
                        "keyword-only arguments: 'value', 'grad', and 'value_fn'")


class _MultiTensorStep:
    """The step of :class:`MultiTensorAdam` and :class:`MultiTensorAdamW`.

    On the card each parameter group takes one
    :func:`~torecsys_tpu_torch.ops.kernels.adam.adam_update`: the kernel
    advances every parameter's float32 step count, then updates every
    element of the group in one pass, a parameter without a gradient as on
    zeros.  On the CPU a parameter without a gradient is given a zero one
    and torch's own single-tensor step runs.  A mix of devices, a dtype
    other than float32, ``amsgrad``, ``maximize`` or a tensor ``lr`` on the
    card raise ``ValueError``."""

    decoupled = False

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0):
        params = list(params)
        on_card = any(p.device.type == "cuda" for p in params)
        super().__init__(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                         foreach=False, capturable=on_card)

    def _state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``p``'s state, built as torch's capturable Adam builds it."""
        state = self.state[p]
        if not state:
            state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
            state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        return state

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for group in self.param_groups for p in group["params"]]
        if _kernels.device_kind(*params) == "cpu":
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            return super().step(closure)
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            if group["amsgrad"] or group["maximize"]:
                raise ValueError("the multi-tensor Adam takes neither amsgrad nor maximize")
            states = [self._state(p) for p in group["params"]]
            b1, b2 = group["betas"]
            _adam_kernel.adam_update(
                group["params"], [p.grad for p in group["params"]],
                [s["exp_avg"] for s in states], [s["exp_avg_sq"] for s in states],
                [s["step"] for s in states], lr=group["lr"], b1=b1, b2=b2, eps=group["eps"],
                weight_decay=group["weight_decay"], decoupled=self.decoupled)
        return loss


class MultiTensorAdam(_MultiTensorStep, torch.optim.Adam):
    """``torch.optim.Adam`` (``foreach=False``; ``capturable=True`` on the
    card), stepped on the card by one multi-tensor kernel a parameter group
    (:class:`_MultiTensorStep`): the plain ``adam`` of :func:`get_optimizer`."""


class MultiTensorAdamW(_MultiTensorStep, torch.optim.AdamW):
    """``torch.optim.AdamW`` the same way (decoupled weight decay, optax's
    default 1e-4): the plain ``adamw`` of :func:`get_optimizer`."""

    decoupled = True

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4):
        super().__init__(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)


def _bool_at(flat: Dict[str, Any], path: str) -> bool:
    """The mask's value at ``path``: its own leaf or the nearest prefix's."""
    parts = path.split("/")
    for i in range(len(parts), 0, -1):
        key = "/".join(parts[:i])
        if key in flat:
            return bool(flat[key])
    raise KeyError(f"the mask has no entry for parameter {path!r}")


def resolve_mask(mask, named: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """``{flax path: bool}`` of an optax-style mask over ``named`` (``{flax
    path: parameter}``): a bool, a nested dict of bools (a prefix holds for
    what is below it), or a callable from the nested dict of the parameters
    to either."""
    from torecsys_tpu_torch.convert import flatten, unflatten

    if callable(mask):
        mask = mask(unflatten(dict(named)))
    if isinstance(mask, Mapping):
        flat = flatten(mask)
        return {path: _bool_at(flat, path) for path in named}
    return {path: bool(mask) for path in named}


# a mask keyword → the group flag it sets
_MASK_FLAGS = {"mask": "decay_on", "weight_decay_mask": "decay_on",
               "trust_ratio_mask": "trust_on"}


class _MaskedFactory:
    """A factory over ``{flax path: parameter}`` (``build_optimizer``) that
    resolves the masks into parameter groups (``decay_on``, ``trust_on``)."""

    takes_paths = True

    def __init__(self, cls, lr, kwargs, masks):
        self.cls, self.lr, self.kwargs, self.masks = cls, lr, kwargs, masks

    def __call__(self, named: Mapping[str, torch.nn.Parameter]) -> torch.optim.Optimizer:
        flags = {_MASK_FLAGS[k]: resolve_mask(m, named) for k, m in self.masks.items()}
        groups: Dict[tuple, list] = {}
        for path, p in named.items():
            groups.setdefault(tuple(f[path] for f in flags.values()), []).append(p)
        param_groups = [{"params": ps, **dict(zip(flags, key))} for key, ps in groups.items()]
        return self.cls(param_groups, lr=self.lr, **self.kwargs)


def build_optimizer(factory, named: Mapping[str, torch.nn.Parameter],
                    paths: Mapping[str, str]) -> torch.optim.Optimizer:
    """``factory`` over the parameters ``named`` (``{port name: parameter}``);
    a factory that resolves masks gets ``{flax path: parameter}`` (``paths``:
    ``convert.flax_paths``)."""
    if getattr(factory, "takes_paths", False):
        return factory({paths[n]: p for n, p in named.items()})
    return factory(list(named.values()))


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
# optax's other names that the JAX get_optimizer reaches by attribute
OPTAX_OTHERS = {
    "adabelief": AdaBelief,
    "adafactor": Adafactor,
    "adamaxw": AdamaxW,
    "adan": Adan,
    "amsgrad": AMSGrad,
    "fromage": Fromage,
    "lbfgs": LBFGS,
    "noisy_sgd": NoisySGD,
    "novograd": NovoGrad,
    "optimistic_adam": OptimisticAdam,
    "optimistic_adam_v2": OptimisticAdamV2,
    "optimistic_gradient_descent": OptimisticGradientDescent,
    "rprop": Rprop,
    "sign_sgd": SignSGD,
    "sm3": SM3,
    "yogi": Yogi,
}
_TORCH_ADAM_KEYS = {"b1", "b2", "eps"}
_TORCH_KEYS = {"adam": _TORCH_ADAM_KEYS, "adamw": _TORCH_ADAM_KEYS | {"weight_decay"}}


def get_optimizer(name: str = "Adam", lr=1e-3, **kwargs: Any) -> Factory:
    """A dense optimizer factory ``params -> torch.optim.Optimizer`` from a
    (torch-style or optax) name: one of the twelve names or of optax's others
    (:data:`OPTAX_OTHERS`), with optax's keyword names and defaults; ``lr``
    (a float or a schedule) may also be passed as ``learning_rate``.
    Unknown names raise ``KeyError``, keywords optax does not take
    ``TypeError`` (``polyak_sgd`` takes no ``learning_rate``: ``TypeError``,
    as the JAX package's ``factory(learning_rate=lr)`` raises)."""
    lr = kwargs.pop("learning_rate", lr)
    key = name.lower()
    if key == "polyak_sgd":
        raise TypeError("polyak_sgd() got an unexpected keyword argument 'learning_rate'")
    cls = _OPTIMIZERS.get(key) or OPTAX_OTHERS.get(key)
    if cls is None:
        raise KeyError(f"unknown optimizer {name!r}; available: "
                       f"{sorted(_OPTIMIZERS) + sorted(OPTAX_OTHERS)}")
    inspect.signature(cls).bind(None, lr, **kwargs)  # TypeError for what optax does not take
    masks = {k: kwargs[k] for k in _MASK_FLAGS
             if k in kwargs and not isinstance(kwargs[k], (bool, type(None)))}
    if masks:
        rest = {k: v for k, v in kwargs.items() if k not in masks}
        return _MaskedFactory(cls, lr, rest, masks)
    if (key in _TORCH_KEYS and lr is not None and not callable(lr)
            and set(kwargs) <= _TORCH_KEYS[key]):
        adam_cls, extra = ((MultiTensorAdam, {}) if key == "adam" else
                           (MultiTensorAdamW, {"weight_decay": kwargs.get("weight_decay", 1e-4)}))
        return functools.partial(adam_cls, lr=lr,
                                 betas=(kwargs.get("b1", 0.9), kwargs.get("b2", 0.999)),
                                 eps=kwargs.get("eps", 1e-8), **extra)
    return functools.partial(cls, lr=lr, **kwargs)


def available_optimizers() -> Dict[str, Any]:
    """``{name: optimizer class}`` of the twelve names of the JAX package's
    registry (``adam``'s and ``adamw``'s are the written-out forms;
    ``get_optimizer`` builds :class:`MultiTensorAdam` and
    :class:`MultiTensorAdamW` for the plain ones); optax's others are
    :data:`OPTAX_OTHERS`."""
    return dict(_OPTIMIZERS)


__all__ = ["AMSGrad", "AdaBelief", "Adadelta", "Adafactor", "Adagrad", "Adam", "AdamW", "Adamax",
           "AdamaxW", "Adan", "Fromage", "LBFGS", "Lamb", "Lars", "Lion", "MultiTensorAdam",
           "MultiTensorAdamW", "NAdam", "NoisySGD", "NovoGrad", "OPTAX_OTHERS", "OptaxOptimizer",
           "OptimisticAdam", "OptimisticAdamV2", "OptimisticGradientDescent", "RAdam", "RMSprop",
           "Rprop", "SGD", "SM3", "SignSGD", "TableGroup", "Yogi", "available_optimizers",
           "build_optimizer", "gaussian_noise", "get_optimizer", "resolve_mask", "state_row_axis"]
