"""Checkpoints: save and restore the whole train state (counterpart of
``torecsys_tpu/train/checkpoint.py``), in a torch format, one file
``ckpt_<step>.pt`` a checkpoint.

A checkpoint is a ``torch.save`` of a dict that holds only tensors (on the
CPU) and plain Python values:

* ``params``: every parameter of the ``Sequential`` by name, the embedding
  tables included, in their dtype;
* ``buffers``: the model's running statistics (``train.state.batch_stats``,
  a BatchNorm's ``mean`` and ``var``) by name; a checkpoint written before
  the port had them has no such key, and restores into a model without
  them;
* ``dense_opt``: the dense optimizer's ``state_dict()``, any optimizer's
  (Adam's moments and its step count, a float32 tensor that a capturable
  Adam keeps on the card; the written-out optax optimizers' slots, and
  their step count on the parameters' device);
* ``row_slots``: on the sparse route, each table's row-wise optimizer slots
  (``RowAdam``'s ``mv``, ``RowAdagrad``'s ``v``, none of ``RowSGD``);
* ``sparse``: whether the state has the sparse route's hybrid layout;
* ``step``, ``loss_sum`` and ``loss_count``: the step counter and the loss
  accumulators.

It is written to ``path + ".tmp"`` and renamed over ``path``, so a reader
never sees half a file.  :func:`restore_checkpoint` loads it on the CPU
(``weights_only=True``, memory-mapped) and copies each tensor into the live
state's tensor in place: device memory does not grow by a second copy of the
table and its slots, and a CUDA graph captured over the state
(``train.steps.make_train_scan``) stays valid.

Under a mesh (``parallel``) whose tables are row-sharded the checkpoint is
format 2: each rank of the first data slice (``d = 0``; the other slices
hold the same rows) writes its shards of every sharded tensor (the table,
its row slots, a dense-route table's optimizer state that holds its rows,
each tensor placed by the axis that indexes them) to
``path + ".shard<t>"``, and then rank 0 writes ``path`` itself, the manifest:
the format-1 content with each sharded tensor recorded by its global shape
and layout instead.  Every rank waits for the whole checkpoint before it
goes on.  Without sharded tables (one device, or a mesh that replicates
everything) rank 0 writes format 1, the whole state.

A restore re-places every tensor by the live state's own layout, whatever
wrote it: a format-1 checkpoint or a format-2 one, of the same mesh, of
another, or restored on one device (each rank reads, memory-mapped, the
global rows it holds).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import re
import time
from typing import Callable, Dict, Optional

import torch
from torch import nn

from torecsys_tpu_torch.train.optimizers import OptaxOptimizer, state_row_axis
from torecsys_tpu_torch.train.sparse import is_hybrid_opt_state
from torecsys_tpu_torch.train.state import TrainState, batch_stats

logger = logging.getLogger(__name__)

FORMAT = 1
SHARDED_FORMAT = 2
_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def checkpoint_name(step: int) -> str:
    return f"ckpt_{int(step)}.pt"


def _dense_optimizer(state: TrainState) -> torch.optim.Optimizer:
    opt = state.opt_state
    return opt["dense"] if is_hybrid_opt_state(opt) else opt


def _cpu(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, dict):
        return {k: _cpu(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_cpu(v) for v in value]
    return value


def _saveable(state_dict: Dict) -> Dict:
    """An optimizer's ``state_dict()`` with a schedule as a hyperparameter
    (a callable, which ``torch.save`` cannot keep) written as its ``repr``:
    the schedule's count is state and is saved; a restore keeps the live
    hyperparameters."""
    groups = [{k: repr(v) if callable(v) else v for k, v in g.items()}
              for g in state_dict["param_groups"]]
    return {**state_dict, "param_groups": groups}


def _checkpoint_dict(seq: nn.Module, state: TrainState) -> Dict:
    """The checkpoint's content: the live state copied to the CPU."""
    hybrid = is_hybrid_opt_state(state.opt_state)
    return {
        "format": FORMAT,
        "sparse": hybrid,
        "params": {name: _cpu(p) for name, p in seq.named_parameters()},
        "buffers": {name: _cpu(b) for name, b in batch_stats(seq).items()},
        "dense_opt": _cpu(_saveable(_dense_optimizer(state).state_dict())),
        "row_slots": ({path: _cpu(slots) for path, slots in state.opt_state["sparse"].items()}
                      if hybrid else {}),
        "step": int(state.step),
        "loss_sum": _cpu(state.loss_sum),
        "loss_count": int(state.loss_count),
    }


def _is_writer() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _sharded_tensors(seq: nn.Module, state: TrainState) -> Dict[str, tuple]:
    """``{key: (live tensor, RowLayout)}`` of every tensor of a row-sharded
    table: ``params/<name>``, ``row_slots/<name>/<slot>`` and the dense
    optimizer's per-parameter state ``dense_opt/<index>/<key>`` that holds
    the table's rows on an axis (``optimizers.state_row_axis``: the
    parameter's shape, adafactor's factor along the rows, sm3's row vector),
    each with its own layout (``sharding.axis_layout``).  The dense
    optimizer's reduced state (a count, adafactor's factor across the rows,
    sm3's other vectors, novograd's ``nu``) is the same on every rank and is
    written once, whole."""
    from torecsys_tpu_torch.parallel.sharding import _table_owners, axis_layout

    out = {}
    opt = _dense_optimizer(state)
    index = _dense_index(opt)
    hybrid = is_hybrid_opt_state(state.opt_state)
    for name, module in _table_owners(seq).items():
        layout = module.row_layout
        if layout is None:
            continue
        p = module.embedding
        out[f"params/{name}"] = (p, layout)
        if hybrid and name in state.opt_state["sparse"]:
            for k, v in state.opt_state["sparse"][name].items():
                out[f"row_slots/{name}/{k}"] = (v, layout)
        if id(p) in index:
            for k, v in opt.state.get(p, {}).items():
                axis = state_row_axis(opt, p, k, v) if isinstance(v, torch.Tensor) else None
                if axis is not None:
                    out[f"dense_opt/{index[id(p)]}/{k}"] = (v, axis_layout(layout, axis))
    return out


def _dense_index(opt) -> Dict[int, int]:
    """``{id(parameter): its index in the optimizer's state_dict}``."""
    return {id(p): i for i, p in enumerate(p for g in opt.param_groups for p in g["params"])}


def _entry(ckpt: Dict, key: str):
    """The (container, last key) of ``key`` in a checkpoint dict."""
    kind, rest = key.split("/", 1)
    if kind == "params":
        return ckpt["params"], rest
    if kind == "row_slots":
        table, slot = rest.rsplit("/", 1)
        return ckpt["row_slots"][table], slot
    i, k = rest.split("/", 1)
    return ckpt["dense_opt"]["state"][int(i)], k


def _barrier(mesh) -> None:
    mesh.world_all_reduce(torch.zeros(1, device=mesh.device))


def save_checkpoint(path: str, seq: nn.Module, state: TrainState, mesh=None) -> str:
    """Write ``seq``'s parameters and ``state`` to ``path`` (through
    ``path + ".tmp"`` and a rename); under a ``mesh`` with row-sharded
    tables, each rank's shards beside it (format 2).  Returns the path."""
    sharded = _sharded_tensors(seq, state) if mesh is not None else {}
    if not sharded:
        if _is_writer():
            _write(path, _checkpoint_dict(seq, state))
        if mesh is not None:
            _barrier(mesh)
        return path
    from torecsys_tpu_torch.parallel.mesh import DATA_AXIS, TABLE_AXIS

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    t = mesh.index(TABLE_AXIS)
    if mesh.index(DATA_AXIS) == 0:
        _write(f"{path}.shard{t}", {key: _cpu(v) for key, (v, _) in sharded.items()})
    _barrier(mesh)  # every shard is on disk before the manifest names it
    if _is_writer():
        ckpt = _checkpoint_dict(seq, state)
        meta = {}
        for key, (v, layout) in sharded.items():
            container, k = _entry(ckpt, key)
            container[k] = torch.empty(0)
            meta[key] = {"rows": layout.rows, "blocks": layout.blocks,
                         "shards": layout.shards,
                         "shape": [layout.rows] + list(v.shape[_lead_dims(v, layout.local_rows):])}
        ckpt.update(format=SHARDED_FORMAT, sharded=meta,
                    shard_files=[f"{os.path.basename(path)}.shard{i}"
                                 for i in range(mesh.shape[TABLE_AXIS])])
        _write(path, ckpt)
    _barrier(mesh)
    return path


def _write(path: str, content: Dict) -> None:
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(content, tmp)
    os.replace(tmp, path)
    logger.info("saved checkpoint %s (%.3f GB) in %.2f s", path,
                os.path.getsize(path) / 1e9, time.perf_counter() - t0)


def _lead_dims(t: torch.Tensor, rows: int) -> int:
    """How many leading axes of a table tensor count its ``rows`` stored
    rows (2 for a field-aware table's ``(N, Vl, W)``, 1 for its flat slots)."""
    for k in range(1, t.dim() + 1):
        if math.prod(t.shape[:k]) == rows:
            return k
    raise ValueError(f"no leading axes of {tuple(t.shape)} count {rows} rows")


def _rows_view(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` as ``(rows, ...)``: its leading axes merged into ``rows``."""
    return t.reshape(rows, *t.shape[_lead_dims(t, rows):])


class _Source:
    """Where a restore reads each saved tensor: the checkpoint dict, and for
    format 2 the shard files (memory-mapped), re-placed by the live
    layouts."""

    def __init__(self, path: str, saved: Dict):
        self.saved = saved
        self.meta = saved.get("sharded", {})
        base = os.path.dirname(path)
        self.shards = [torch.load(os.path.join(base, name), map_location="cpu",
                                  weights_only=True, mmap=True)
                       for name in saved.get("shard_files", [])]

    def fetch(self, key: str, value: torch.Tensor, live: torch.Tensor, layout) -> torch.Tensor:
        """The saved tensor of ``key`` as the live one holds it: this rank's
        rows under ``layout`` (None: the whole tensor)."""
        from torecsys_tpu_torch.parallel.sharding import RowLayout

        meta = self.meta.get(key)
        if meta is None:
            if layout is None:
                return value
            return _rows_view(value, layout.rows)[layout.global_rows()].reshape(live.shape)
        rows = (layout.global_rows() if layout is not None
                else torch.arange(meta["rows"], dtype=torch.int64))
        saved_layout = RowLayout(rows=meta["rows"], shards=meta["shards"], index=0,
                                 blocks=meta["blocks"])
        owner = saved_layout.owner(rows)
        out = torch.empty((rows.shape[0], *meta["shape"][1:]),
                          dtype=self.shards[0][key].dtype)
        for s, shard in enumerate(self.shards):
            lay = dataclasses.replace(saved_layout, index=s)
            sel = (owner == s).nonzero().squeeze(1)
            out[sel] = _rows_view(shard[key], lay.local_rows)[lay.local(rows[sel])]
        return out.reshape(live.shape)


def _copy_into(dst: torch.Tensor, src: torch.Tensor, what: str) -> None:
    if tuple(dst.shape) != tuple(src.shape) or dst.dtype != src.dtype:
        raise ValueError(f"checkpoint {what}: {tuple(src.shape)} {src.dtype} does not fit the "
                         f"live {tuple(dst.shape)} {dst.dtype} (another model, table size or "
                         "set_table_dtype?)")
    dst.copy_(src)


def _restore_dense_optimizer(opt: torch.optim.Optimizer, saved: Dict,
                             fetch: Callable = lambda i, k, v, live: v) -> None:
    """Copy a saved ``state_dict()`` into ``opt``'s per-parameter state, in
    place where the live state already has the tensor; the live
    hyperparameters stay.  ``fetch(i, key, saved value, live tensor)``
    re-places a saved tensor for the live one."""
    params = [p for group in opt.param_groups for p in group["params"]]
    sizes = [len(g["params"]) for g in saved["param_groups"]]
    if sizes != [len(g["params"]) for g in opt.param_groups]:
        raise ValueError(f"checkpoint dense optimizer has parameter groups of {sizes}, the live "
                         f"one {[len(g['params']) for g in opt.param_groups]}")
    # a capturable optimizer (Adam on the card, every written-out optax one)
    # keeps its step on the parameter's device; a CPU Adam keeps it on the CPU
    step_on_device = bool(opt.defaults.get("capturable", False))
    for i, p in enumerate(params):
        if i not in saved["state"]:
            # saved before this parameter's first step by an optimizer that
            # builds its state then (torch's); one that builds it with
            # itself (the written-out optax ones) never saves it empty
            if isinstance(opt, OptaxOptimizer):
                raise ValueError(f"checkpoint dense optimizer state of parameter {i} is empty "
                                 f"and does not match the live {sorted(opt.state[p])} (another "
                                 "optimizer?)")
            opt.state.pop(p, None)
            continue
        live = opt.state.get(p)
        if not live:  # torch's lazily built state (Adam's before its first step)
            opt.state[p] = {k: fetch(i, k, v, p).to(p.device if k != "step" or step_on_device
                                                    else "cpu")
                            for k, v in saved["state"][i].items()}
            continue
        if set(live) != set(saved["state"][i]):
            raise ValueError(f"checkpoint dense optimizer state {sorted(saved['state'][i])} of "
                             f"parameter {i} does not match the live {sorted(live)} (another "
                             "optimizer or setting?)")
        for k, v in saved["state"][i].items():
            _copy_into(live[k], fetch(i, k, v, live[k]),
                       f"dense optimizer state {k!r} of parameter {i}")


def restore_checkpoint(path: str, seq: nn.Module, state: TrainState) -> TrainState:
    """Restore a checkpoint of :func:`save_checkpoint` into ``seq`` and
    ``state``, in place; returns ``state``.

    The pipeline must be built as for the saved run (same model, inputs and
    optimizer).  A checkpoint of the sparse route cannot restore onto the
    dense route, nor the reverse: their optimizer states differ in layout,
    and this raises ``ValueError`` naming ``set_sparse_embeddings``.  Each
    tensor is re-placed by the live state's layout (``_Source``).
    """
    t0 = time.perf_counter()
    saved = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if saved.get("format") not in (FORMAT, SHARDED_FORMAT):
        raise ValueError(f"{path!r} is not a checkpoint of this format (format "
                         f"{saved.get('format')!r}, expected {FORMAT} or {SHARDED_FORMAT})")
    source = _Source(path, saved)
    layouts = {key: layout for key, (_, layout) in _sharded_tensors(seq, state).items()}
    # a sharded parameter's dense optimizer state may not be built yet
    # (torch's Adam builds it at the first step): its row tensors take the
    # parameter's layout
    opt = _dense_optimizer(state)
    index, named = _dense_index(opt), dict(seq.named_parameters())
    for key, layout in list(layouts.items()):
        p = named.get(key[7:]) if key.startswith("params/") else None
        if p is not None and id(p) in index and not opt.state.get(p):
            layouts[f"dense_opt/{index[id(p)]}"] = layout

    def fetch(key, value, live):
        layout = layouts.get(key)
        if layout is None and key.startswith("dense_opt/"):
            layout = layouts.get(key.rsplit("/", 1)[0])
            rows = layout.rows if layout is not None else None
            if layout is not None and key not in source.meta and (
                    value.dim() == 0 or math.prod(value.shape[:-1]) != rows):
                layout = None  # a scalar of the state (its step), not rows
        return source.fetch(key, value, live, layout)

    hybrid = is_hybrid_opt_state(state.opt_state)
    if bool(saved["sparse"]) != hybrid:
        raise ValueError(
            f"checkpoint {path!r} was saved on the {'sparse' if saved['sparse'] else 'dense'} "
            f"embedding route but this trainer runs the {'sparse' if hybrid else 'dense'} one; "
            "the optimizer-state layouts are incompatible: set "
            "Pipeline.set_sparse_embeddings to match the checkpoint (or retrain)")
    if set(saved["params"]) != set(named):
        raise ValueError(f"checkpoint {path!r} holds parameters "
                         f"{sorted(set(saved['params']) ^ set(named))} that the model does "
                         "not have, or lacks some it has")
    buffers = batch_stats(seq)
    saved_buffers = saved.get("buffers", {})
    if set(saved_buffers) != set(buffers):
        raise ValueError(f"checkpoint {path!r} holds running statistics "
                         f"{sorted(set(saved_buffers) ^ set(buffers))} that the model does not "
                         "have, or lacks some it has")
    with torch.no_grad():
        for name, value in saved["params"].items():
            _copy_into(named[name], fetch(f"params/{name}", value, named[name]),
                       f"parameter {name!r}")
        for name, value in saved_buffers.items():
            _copy_into(buffers[name], value, f"buffer {name!r}")
        _restore_dense_optimizer(_dense_optimizer(state), saved["dense_opt"],
                                 lambda i, k, v, live: fetch(f"dense_opt/{i}/{k}", v, live))
        if hybrid:
            live_slots = state.opt_state["sparse"]
            if set(saved["row_slots"]) != set(live_slots):
                raise ValueError(f"checkpoint {path!r} has row slots for "
                                 f"{sorted(saved['row_slots'])}, the trainer for "
                                 f"{sorted(live_slots)}")
            for table, slots in saved["row_slots"].items():
                if set(slots) != set(live_slots[table]):
                    raise ValueError(f"checkpoint row slots {sorted(slots)} of {table!r} do "
                                     f"not match {sorted(live_slots[table])}")
                for k, v in slots.items():
                    live = live_slots[table][k]
                    _copy_into(live, fetch(f"row_slots/{table}/{k}", v, live),
                               f"row slot {k!r} of {table!r}")
        state.step.fill_(saved["step"])
        _copy_into(state.loss_sum, saved["loss_sum"], "loss_sum")
    state.loss_count = int(saved["loss_count"])
    logger.info("restored checkpoint %s (step %d) in %.2f s", path, saved["step"],
                time.perf_counter() - t0)
    return state


def latest_checkpoint(directory: str) -> Optional[str]:
    """Path of the ``ckpt_<step>.pt`` with the largest step in
    ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        m = _NAME.match(name)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(directory, name), int(m.group(1))
    return best


__all__ = ["checkpoint_name", "latest_checkpoint", "restore_checkpoint", "save_checkpoint"]
