"""Weight carry-over from the JAX package's parameters into the port.

The JAX package keeps its parameters as a nested dict (flax), the port in
``nn.Module``s.  :func:`from_flax_params` copies the first into the second:

* ``inputs/schema_<name>/embedding`` → ``inputs.schema.<name>.embedding``,
  the packed ``(ceil(V/P), P*E)`` table (a field-aware table's
  ``(N, ceil(V/P), P*E)``), as it is (both sides store the same layout,
  float32 or bfloat16); a container's child ``inputs_<i>`` is
  ``inputs.<i>``;
* ``model/.../kernel`` → ``model.....weight``, transposed (its axes
  reversed: a Dense kernel ``(in, out)`` becomes ``(out, in)``, PNN's outer
  kernel ``(E, P, E)`` its reverse); every other parameter as it is.

With ``batch_stats`` it fills the model's running statistics (flax's
``batch_stats`` collection, a BatchNorm's ``mean`` and ``var``) into the
port's buffers of the same names.

With ``opt_state_np`` it also carries the optimizer state into a port
:class:`~torecsys_tpu_torch.train.TrainState`: optax Adam's ``count``,
``mu`` and ``nu`` into the ``torch.optim.Adam`` (over the dense parameters
on the sparse route, over every parameter on the dense route), and on the
sparse route each table's row-wise slots as they are (``RowAdam``'s ``mv``,
``RowAdagrad``'s ``v``; :func:`copy_row_slots`; a field-aware table's
``(N, Vp, ...)`` slots into the port's ``(N*Vp, ...)``), so that both sides
take their next step from the same state.

Arrays come in as numpy (``jax.device_get`` of the JAX side); this module
needs neither JAX nor the JAX package.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

SEP = "/"
_SCHEMA = "schema_"
_CHILD = re.compile(r"^inputs_(\d+)$")


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    """Nested dict → ``{"a/b/c": leaf}``."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{SEP}{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def torch_name(flax_path: str) -> str:
    """Flax parameter path → the port's parameter name."""
    parts = flax_path.split(SEP)
    if len(parts) > 1 and parts[0] == "inputs" and parts[1].startswith(_SCHEMA):
        parts = ["inputs", "schema", parts[1][len(_SCHEMA):], *parts[2:]]
    parts = [f"inputs.{m.group(1)}" if (m := _CHILD.match(p)) else p for p in parts]
    if parts[-1] == "kernel":
        parts[-1] = "weight"
    return ".".join(parts)


def flax_path(name: str) -> str:
    """The port's parameter name → the flax parameter path: the inverse of
    :func:`torch_name` (``inputs.schema.<name>`` → ``inputs/schema_<name>``,
    a container's child ``inputs.<i>`` → ``inputs_<i>``, ``weight`` →
    ``kernel``)."""
    parts = name.split(".")
    out = []
    if len(parts) > 2 and parts[:2] == ["inputs", "schema"]:
        out, parts = ["inputs", _SCHEMA + parts[2]], parts[3:]
    i = 0
    while i < len(parts):
        if parts[i] == "inputs" and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"inputs_{parts[i + 1]}")
            i += 2
            continue
        out.append(parts[i])
        i += 1
    if out[-1] == "weight":
        out[-1] = "kernel"
    return SEP.join(out)


def _numpy_to_torch(arr: np.ndarray) -> torch.Tensor:
    """A numpy array as a tensor; a bfloat16 array (ml_dtypes, what
    ``jax.device_get`` gives of a bf16 array) keeps its bits."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _as_torch(flax_path: str, value, like: torch.Tensor) -> torch.Tensor:
    arr = np.asarray(value)
    if flax_path.split(SEP)[-1] == "kernel":
        arr = arr.T
    t = _numpy_to_torch(arr).to(dtype=like.dtype, device=like.device)
    if t.shape != like.shape:
        raise ValueError(f"{flax_path}: shape {tuple(t.shape)} does not fit "
                         f"{torch_name(flax_path)} {tuple(like.shape)}")
    return t


def _get(obj, name: str):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def from_flax_params(seq: nn.Module, params_np: Mapping,
                     opt_state_np: Optional[Mapping] = None, state=None,
                     batch_stats: Optional[Mapping] = None) -> nn.Module:
    """Fill ``seq``'s parameters (in place) from the JAX package's params.

    Args:
        seq: the port's ``Sequential`` (or any module with matching names).
        params_np: the flax ``params`` tree as numpy arrays.
        opt_state_np: optionally the JAX optimizer state as numpy: the
            hybrid layout ``{"dense": <optax Adam state, or the chain tuple
            starting with it: fields count, mu, nu keyed by flat "/" paths>,
            "sparse": {"<flax table path>": {"mv": (R, 2, W)}}}`` (or
            ``{"v": (R, W)}``) of the
            sparse route, or the dense route's plain optax Adam state over
            every parameter, the tables included.
        state: the port's ``TrainState`` to receive ``opt_state_np``.
        batch_stats: optionally flax's ``batch_stats`` tree as numpy, copied
            into the buffers of the same names; each must exist.

    Returns:
        ``seq``.  Every parameter of ``seq`` must be filled.
    """
    named = dict(seq.named_parameters())
    flat = flatten(params_np)
    missing = set(named) - {torch_name(p) for p in flat}
    if missing:
        raise KeyError(f"parameters not in the flax tree: {sorted(missing)}")
    with torch.no_grad():
        for path, value in flat.items():
            name = torch_name(path)
            if name not in named:
                raise KeyError(f"flax parameter {path!r} has no counterpart {name!r}")
            named[name].copy_(_as_torch(path, value, named[name]))
    if batch_stats is not None:
        buffers = dict(seq.named_buffers())
        with torch.no_grad():
            for path, value in flatten(batch_stats).items():
                name = torch_name(path)
                if name not in buffers:
                    raise KeyError(f"flax batch_stats {path!r} has no buffer {name!r}")
                buffers[name].copy_(_as_torch(path, value, buffers[name]))
    if opt_state_np is not None:
        if state is None:
            raise ValueError("opt_state_np needs the port's TrainState to fill")
        _carry_opt_state(named, opt_state_np, state)
    return seq


def _carry_opt_state(named: Dict[str, nn.Parameter], opt_state_np: Mapping, state) -> None:
    hybrid = isinstance(opt_state_np, Mapping) and "sparse" in opt_state_np
    dense = opt_state_np["dense"] if hybrid else opt_state_np
    if not (isinstance(dense, Mapping) or hasattr(dense, "mu")):
        dense = dense[0]  # optax.adam is a chain; its first state holds the moments
    count = int(np.asarray(_get(dense, "count")))
    mu, nu = flatten(_get(dense, "mu")), flatten(_get(dense, "nu"))
    adam = state.opt_state["dense"] if hybrid else state.opt_state
    with torch.no_grad():
        for path in mu:
            p = named[torch_name(path)]
            # a capturable Adam (on the card) keeps its step on the card
            step_device = p.device if adam.defaults.get("capturable") else "cpu"
            adam.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32, device=step_device),
                "exp_avg": _as_torch(path, mu[path], p),
                "exp_avg_sq": _as_torch(path, nu[path], p),
            }
        for path, slots in (opt_state_np["sparse"].items() if hybrid else ()):
            copy_row_slots(slots, state.opt_state["sparse"][torch_name(path)])
        state.step.fill_(count)


def copy_row_slots(slots_np: Mapping, port_slots: Dict[str, torch.Tensor]) -> None:
    """Copy one table's row-wise optimizer slots from the JAX package (numpy;
    ``{"mv": (R, 2, W)}`` of ``RowAdam``, ``{"v": (R, W)}`` of ``RowAdagrad``,
    ``{}`` of ``RowSGD``) into the port's, in place; the names must match,
    and the shapes but for the leading stored-row axes, which the port
    flattens (a field-aware table's ``(N, Vp, 2, W)`` fills ``(N*Vp, 2, W)``)."""
    if set(slots_np) != set(port_slots):
        raise KeyError(f"row slots {sorted(slots_np)} do not match {sorted(port_slots)}")
    with torch.no_grad():
        for k, v in slots_np.items():
            arr = np.asarray(v)
            shape = tuple(port_slots[k].shape)
            if arr.ndim > len(shape) and arr.shape[arr.ndim - len(shape) + 1:] == shape[1:]:
                arr = arr.reshape(shape)
            if arr.shape != shape:
                raise ValueError(f"row slot {k!r}: shape {arr.shape} does not fit "
                                 f"{tuple(port_slots[k].shape)}")
            port_slots[k].copy_(_numpy_to_torch(arr))


__all__ = ["copy_row_slots", "flatten", "flax_path", "from_flax_params", "torch_name"]
