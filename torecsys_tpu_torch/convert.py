"""Weight carry-over from the JAX package's parameters into the port.

The JAX package keeps its parameters as a nested dict (flax), the port in
``nn.Module``s.  :func:`from_flax_params` copies the first into the second:

* ``inputs/schema_<name>/embedding`` → ``inputs.schema.<name>.embedding``,
  the packed ``(ceil(V/P), P*E)`` table, as it is (both sides store the
  same layout);
* ``model/.../kernel`` ``(in, out)`` → ``model.....weight`` ``(out, in)``,
  transposed; ``bias`` as it is.

With ``opt_state_np`` it also carries the optimizer state into a port
:class:`~torecsys_tpu_torch.train.TrainState`: optax Adam's ``count``,
``mu`` and ``nu`` into the ``torch.optim.Adam`` (over the dense parameters
on the sparse route, over every parameter on the dense route), and on the
sparse route each table's ``RowAdam`` ``mv`` slot as it is, so that both
sides take their next step from the same state.

Arrays come in as numpy (``jax.device_get`` of the JAX side); this module
needs neither JAX nor the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

SEP = "/"
_SCHEMA = "schema_"


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
    if parts[-1] == "kernel":
        parts[-1] = "weight"
    return ".".join(parts)


def _as_torch(flax_path: str, value, like: torch.Tensor) -> torch.Tensor:
    arr = np.asarray(value)
    if flax_path.endswith(SEP + "kernel"):
        arr = arr.T
    t = torch.tensor(arr, dtype=like.dtype, device=like.device)
    if t.shape != like.shape:
        raise ValueError(f"{flax_path}: shape {tuple(t.shape)} does not fit "
                         f"{torch_name(flax_path)} {tuple(like.shape)}")
    return t


def _get(obj, name: str):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def from_flax_params(seq: nn.Module, params_np: Mapping,
                     opt_state_np: Optional[Mapping] = None, state=None) -> nn.Module:
    """Fill ``seq``'s parameters (in place) from the JAX package's params.

    Args:
        seq: the port's ``Sequential`` (or any module with matching names).
        params_np: the flax ``params`` tree as numpy arrays.
        opt_state_np: optionally the JAX optimizer state as numpy: the
            hybrid layout ``{"dense": <optax Adam state, or the chain tuple
            starting with it: fields count, mu, nu keyed by flat "/" paths>,
            "sparse": {"<flax table path>": {"mv": (R, 2, W)}}}`` of the
            sparse route, or the dense route's plain optax Adam state over
            every parameter, the tables included.
        state: the port's ``TrainState`` to receive ``opt_state_np``.

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
            adam.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": _as_torch(path, mu[path], p),
                "exp_avg_sq": _as_torch(path, nu[path], p),
            }
        for path, slots in (opt_state_np["sparse"].items() if hybrid else ()):
            port_slots = state.opt_state["sparse"][torch_name(path)]
            for k, v in slots.items():
                port_slots[k].copy_(torch.tensor(np.asarray(v)))
        state.step.fill_(count)


__all__ = ["flatten", "from_flax_params", "torch_name"]
