"""Weight carry-over from the JAX package's parameters into the port.

The JAX package keeps its parameters as a nested dict (flax), the port in
``nn.Module``s.  :func:`from_flax_params` copies the first into the second:

* ``inputs/schema_<name>/embedding`` → ``inputs.schema.<name>.embedding``,
  the packed ``(ceil(V/P), P*E)`` table (a field-aware table's
  ``(N, ceil(V/P), P*E)``), as it is (both sides store the same layout,
  float32 or bfloat16); a container's child ``inputs_<i>`` is
  ``inputs.<i>``, and a nested ``Inputs``' entry ``schema_<name>`` is
  ``schema.<name>`` (PAL's ``pctr_inputs``);
* ``model/.../kernel`` → ``model.....weight``, transposed (its axes
  reversed: a Dense kernel ``(in, out)`` becomes ``(out, in)``, PNN's outer
  kernel ``(E, P, E)`` its reverse, the attention's ``query`` kernel ``(in,
  H, D/H)`` ``(D/H, H, in)`` and its ``out`` kernel ``(H, D/H, out)``
  ``(out, D/H, H)``: the port's ``DenseGeneral`` keeps that layout), but a
  4-D kernel, a convolution's ``(kh, kw, in, out)``, becomes torch's
  ``(out, in, kh, kw)`` (:func:`flax_array` is the inverse); every
  other parameter as it is.  The other paths are the same on both sides:
  the experts of an MoE layer are named as flax names them
  (``_FlatMLPExpert_<i>/MultilayerPerceptionLayer_0``), PAL's wrapped
  model is ``pctr_model``, PRM's batch norms ``attn_bn_<i>`` and
  ``ff_bn_<i>``.

With ``batch_stats`` it fills the model's running statistics (flax's
``batch_stats`` collection, a BatchNorm's ``mean`` and ``var``) into the
port's buffers of the same names.

With ``opt_state_np`` it also carries the optimizer state into a port
:class:`~torecsys_tpu_torch.train.TrainState`: every field of the optax
chain (:func:`optax_fields`: adam's, lamb's and nadam's ``count``/``mu``/
``nu``, adagrad's ``sum_of_squares``, rmsprop's ``nu`` and ``mu``, lion's
``mu``, lars' and sgd's momentum ``trace``, adadelta's ``e_g``/``e_x``)
into the dense optimizer's state of the same name (over the dense
parameters on the sparse route, over every parameter on the dense route;
``torch.optim.Adam``'s ``exp_avg``/``exp_avg_sq``), and on the
sparse route each table's row-wise slots as they are (``RowAdam``'s ``mv``,
``RowAdagrad``'s ``v``; :func:`copy_row_slots`; a field-aware table's
``(N, Vp, ...)`` slots into the port's ``(N*Vp, ...)``), so that both sides
take their next step from the same state.

Into a trainer under a mesh (``parallel``) whose tables are row-sharded,
each rank takes its own rows of the global arrays (a JAX sharded state
gathered with ``jax.device_get``): the table, its row slots and, on the
dense route, the optimizer state tensors that hold its rows (by the axis
that indexes them); the reduced ones (adafactor's factor across the rows,
sm3's other vectors, novograd's ``nu``) whole.

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


def unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{"a/b/c": leaf}`` → nested dict: the inverse of :func:`flatten`."""
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        *heads, last = path.split(SEP)
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def torch_name(flax_path: str) -> str:
    """Flax parameter path → the port's parameter name."""
    parts = flax_path.split(SEP)
    if len(parts) > 1 and parts[0] == "inputs":
        # an Inputs' schema entry, also of an Inputs nested in one (PAL's
        # pctr_inputs): schema_<name> → schema.<name>
        parts = ["inputs", *(f"schema.{p[len(_SCHEMA):]}" if p.startswith(_SCHEMA) else p
                             for p in parts[1:])]
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
        if out[:1] == ["inputs"] and parts[i] == "schema" and i + 2 < len(parts):
            out.append(_SCHEMA + parts[i + 1])  # a nested Inputs' entry
            i += 2
            continue
        out.append(parts[i])
        i += 1
    if out[-1] == "weight":
        out[-1] = "kernel"
    return SEP.join(out)


def flax_paths(module: nn.Module) -> Dict[str, str]:
    """``{the port's parameter name: flax path}`` of every parameter of
    ``module``: :func:`flax_path` of each name, but a layer whose flax
    parameter is itself called ``weight`` (``keeps_flax_weight = True``:
    the FiBiNET bilinear layers) keeps that name, which :func:`flax_path`
    alone would read as a Dense ``kernel``."""
    out = {}
    for mname, m in module.named_modules():
        for pname, _ in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            path = flax_path(name)
            if pname == "weight" and getattr(m, "keeps_flax_weight", False):
                path = path[:-len("kernel")] + "weight"
            out[name] = path
    return out


def _numpy_to_torch(arr: np.ndarray) -> torch.Tensor:
    """A numpy array as a tensor; a bfloat16 array (ml_dtypes, what
    ``jax.device_get`` gives of a bf16 array) keeps its bits."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _layouts(seq: nn.Module) -> Dict[str, Any]:
    """``{parameter name: RowLayout}`` of ``seq``'s row-sharded tables."""
    from torecsys_tpu_torch.parallel.sharding import _table_owners

    return {name: m.row_layout for name, m in _table_owners(seq).items()
            if m.row_layout is not None}


def _as_torch(flax_path: str, value, like: torch.Tensor, layout=None) -> torch.Tensor:
    arr = np.asarray(value)
    if layout is not None:  # a row-sharded table: this rank's rows of the global array
        from torecsys_tpu_torch.parallel.sharding import local_shard

        arr = local_shard(arr, layout)
    if flax_path.split(SEP)[-1] == "kernel":
        # a convolution's (kh, kw, in, out) → (out, in, kh, kw); else reversed
        arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
    t = _numpy_to_torch(arr).to(dtype=like.dtype, device=like.device)
    if t.shape != like.shape:
        raise ValueError(f"{flax_path}: shape {tuple(t.shape)} does not fit "
                         f"{torch_name(flax_path)} {tuple(like.shape)}")
    return t


def flax_array(flax_path: str, value: torch.Tensor) -> np.ndarray:
    """A port parameter as the JAX package's array at ``flax_path``: the
    inverse of the layout rule of :func:`from_flax_params` (a ``kernel``'s
    axes reversed, a 4-D one from ``(out, in, kh, kw)`` to ``(kh, kw, in,
    out)``)."""
    arr = value.detach().cpu()
    if flax_path.split(SEP)[-1] == "kernel":
        arr = arr.permute(2, 3, 1, 0) if arr.dim() == 4 else arr.permute(
            *range(arr.dim() - 1, -1, -1))
    return arr.contiguous().numpy()


def from_flax_params(seq: nn.Module, params_np: Mapping,
                     opt_state_np: Optional[Mapping] = None, state=None,
                     batch_stats: Optional[Mapping] = None,
                     step: Optional[int] = None) -> nn.Module:
    """Fill ``seq``'s parameters (in place) from the JAX package's params.

    Args:
        seq: the port's ``Sequential`` (or any module with matching names).
        params_np: the flax ``params`` tree as numpy arrays.
        opt_state_np: optionally the JAX optimizer state as numpy: the
            hybrid layout ``{"dense": <the optax state of the named
            optimizer (:func:`optax_fields`)>, "sparse": {"<flax table
            path>": {"mv": (R, 2, W)}}}`` (or ``{"v": (R, W)}``, or ``{}``)
            of the sparse route, or the dense route's plain optax state over
            every parameter, the tables included.
        state: the port's ``TrainState`` to receive ``opt_state_np``.
        batch_stats: optionally flax's ``batch_stats`` tree as numpy, copied
            into the buffers of the same names; each must exist.
        step: the JAX state's step, for ``state.step`` (default: the optax
            state's ``count``, where it has one).

    Returns:
        ``seq``.  Every parameter of ``seq`` must be filled.
    """
    named = dict(seq.named_parameters())
    layouts = _layouts(seq)
    flat = flatten(params_np)
    missing = set(named) - {torch_name(p) for p in flat}
    if missing:
        raise KeyError(f"parameters not in the flax tree: {sorted(missing)}")
    with torch.no_grad():
        for path, value in flat.items():
            name = torch_name(path)
            if name not in named:
                raise KeyError(f"flax parameter {path!r} has no counterpart {name!r}")
            named[name].copy_(_as_torch(path, value, named[name], layouts.get(name)))
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
        _carry_opt_state(named, opt_state_np, state, step, layouts)
    return seq


def optax_fields(opt_state) -> Dict[str, Any]:
    """The named fields of an optax state as ``{field: value}``: a chain's
    tuple walked by position, a masked state's ``inner_state`` entered, the
    empty states skipped (adamw's ``(ScaleByAdamState(count, mu, nu),
    EmptyState(), EmptyState())`` gives ``count``, ``mu`` and ``nu``).  A
    mapping (``{"count": ..., "mu": ..., "nu": ...}``) is taken as it is.
    Each field appears once in a chain of the JAX package's registry."""
    out: Dict[str, Any] = {}

    def put(name, value):
        if name in out:
            raise ValueError(f"optax state field {name!r} appears twice in the chain")
        out[name] = value

    def walk(state):
        if isinstance(state, Mapping):
            for k, v in state.items():
                put(k, v)
        elif hasattr(state, "_fields"):  # a NamedTuple state
            for k in state._fields:
                if k == "inner_state":
                    walk(getattr(state, k))
                else:
                    put(k, getattr(state, k))
        elif isinstance(state, (tuple, list)):
            for s in state:
                walk(s)
        else:
            raise TypeError(f"not an optax state: {type(state).__name__}")

    walk(opt_state)
    return out


# optax's field names → torch.optim.Adam's (and AdamW's) state keys
_TORCH_ADAM_KEYS = {"mu": "exp_avg", "nu": "exp_avg_sq"}


def _state_leaves(field: str, path: str, value):
    """``(port state key, value)`` of one optax state leaf: the leaf itself,
    but a list of per-axis vectors (sm3's ``mu``) gives ``<field>_<axis>``
    by the port parameter's axes (a flax ``kernel``'s axes reversed, a 4-D
    one's as ``_as_torch`` moves them)."""
    if not isinstance(value, (list, tuple)):
        return [(field, value)]
    nd = len(value)
    order = list(range(nd))
    if path.split(SEP)[-1] == "kernel":
        order = [3, 2, 0, 1] if nd == 4 else order[::-1]
    return [(f"{field}_{j}", value[i]) for j, i in enumerate(order)]


def _carry_opt_state(named: Dict[str, nn.Parameter], opt_state_np: Mapping, state,
                     step: Optional[int], layouts: Optional[Dict] = None) -> None:
    """Fill the port's optimizer state from the JAX package's: each optax
    field's tree into the per-parameter state key of the same name
    (``torch.optim.Adam``'s ``exp_avg``/``exp_avg_sq`` for ``mu``/``nu``,
    sm3's per-axis ``mu`` into ``mu_<axis>``), flax kernels transposed;
    ``count`` into each parameter's ``step``; the row-wise slots of the
    sparse route as they are.  Of a row-sharded table, each state tensor
    that holds the table's rows takes this rank's
    (``optimizers.state_row_axis``), a reduced one is taken whole."""
    from torecsys_tpu_torch.parallel.sharding import axis_layout
    from torecsys_tpu_torch.train.optimizers import state_row_axis

    hybrid = isinstance(opt_state_np, Mapping) and "sparse" in opt_state_np
    fields = optax_fields(opt_state_np["dense"] if hybrid else opt_state_np)
    count = fields.pop("count", None)
    count = None if count is None else int(np.asarray(count))
    opt = state.opt_state["dense"] if hybrid else state.opt_state
    torch_adam = isinstance(opt, (torch.optim.Adam, torch.optim.AdamW))
    rename = _TORCH_ADAM_KEYS if torch_adam else {}
    trees = {rename.get(k, k): flatten(v) for k, v in fields.items()}
    paths = sorted({path for tree in trees.values() for path in tree})
    with torch.no_grad():
        for path in paths:
            p = named[torch_name(path)]
            layout = (layouts or {}).get(torch_name(path))
            live = opt.state.get(p)
            values = {}
            for field, tree in trees.items():
                for k, value in _state_leaves(field, path, tree[path]):
                    # a lazily built state (torch's Adam) takes the parameter's shape
                    like = live[k] if live and k in live else p
                    lay = None if layout is None else axis_layout(
                        layout, state_row_axis(opt, p, k, like))
                    values[k] = _as_torch(path, value, like, lay)
            if not live:  # torch's lazily built state: Adam's before its first step
                if count is None:
                    raise ValueError(f"the optax state has no count for {type(opt).__name__}")
                # a capturable Adam (on the card) keeps its step on the card
                step_device = p.device if opt.defaults.get("capturable") else "cpu"
                opt.state[p] = {"step": torch.tensor(float(count), dtype=torch.float32,
                                                     device=step_device), **values}
                continue
            if set(live) - {"step"} != set(values):
                raise KeyError(f"optax state {sorted(values)} of {path!r} does not match the "
                               f"port optimizer's {sorted(set(live) - {'step'})}")
            for k, v in values.items():
                live[k].copy_(v)
            if "step" in live:
                if count is None:
                    raise ValueError(f"the port optimizer counts steps, the optax state of "
                                     f"{path!r} has no count")
                live["step"].fill_(count)
        for path, slots in (opt_state_np["sparse"].items() if hybrid else ()):
            copy_row_slots(slots, state.opt_state["sparse"][torch_name(path)],
                           (layouts or {}).get(torch_name(path)))
        if step is not None or count is not None:
            state.step.fill_(count if step is None else step)


def copy_row_slots(slots_np: Mapping, port_slots: Dict[str, torch.Tensor],
                   layout=None) -> None:
    """Copy one table's row-wise optimizer slots from the JAX package (numpy;
    ``{"mv": (R, 2, W)}`` of ``RowAdam``, ``{"v": (R, W)}`` of ``RowAdagrad``,
    ``{}`` of ``RowSGD``) into the port's, in place; the names must match,
    and the shapes but for the leading stored-row axes, which the port
    flattens (a field-aware table's ``(N, Vp, 2, W)`` fills ``(N*Vp, 2, W)``).
    With ``layout`` (a row-sharded table) the global slots give this rank's
    rows."""
    if set(slots_np) != set(port_slots):
        raise KeyError(f"row slots {sorted(slots_np)} do not match {sorted(port_slots)}")
    with torch.no_grad():
        for k, v in slots_np.items():
            arr = np.asarray(v)
            if layout is not None:
                from torecsys_tpu_torch.parallel.sharding import local_shard

                arr = local_shard(arr, layout)
            shape = tuple(port_slots[k].shape)
            if arr.ndim > len(shape) and arr.shape[arr.ndim - len(shape) + 1:] == shape[1:]:
                arr = arr.reshape(shape)
            if arr.shape != shape:
                raise ValueError(f"row slot {k!r}: shape {arr.shape} does not fit "
                                 f"{tuple(port_slots[k].shape)}")
            port_slots[k].copy_(_numpy_to_torch(arr))


__all__ = ["copy_row_slots", "flatten", "flax_array", "flax_path", "flax_paths",
           "from_flax_params", "optax_fields", "torch_name", "unflatten"]
