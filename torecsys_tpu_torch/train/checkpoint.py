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

One process: the whole state lives in this process.  When a
``torch.distributed`` process group is initialised, only rank 0 writes (the
state is replicated; sharded tables are not ported).
"""

from __future__ import annotations

import logging
import os
import re
import time
from typing import Dict, Optional

import torch
from torch import nn

from torecsys_tpu_torch.train.optimizers import OptaxOptimizer
from torecsys_tpu_torch.train.sparse import is_hybrid_opt_state
from torecsys_tpu_torch.train.state import TrainState, batch_stats

logger = logging.getLogger(__name__)

FORMAT = 1
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


def save_checkpoint(path: str, seq: nn.Module, state: TrainState) -> str:
    """Write ``seq``'s parameters and ``state`` to ``path`` (through
    ``path + ".tmp"`` and a rename).  Returns the path."""
    if not _is_writer():
        return path
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_checkpoint_dict(seq, state), tmp)
    os.replace(tmp, path)
    logger.info("saved checkpoint %s (%.3f GB) in %.2f s", path,
                os.path.getsize(path) / 1e9, time.perf_counter() - t0)
    return path


def _copy_into(dst: torch.Tensor, src: torch.Tensor, what: str) -> None:
    if tuple(dst.shape) != tuple(src.shape) or dst.dtype != src.dtype:
        raise ValueError(f"checkpoint {what}: {tuple(src.shape)} {src.dtype} does not fit the "
                         f"live {tuple(dst.shape)} {dst.dtype} (another model, table size or "
                         "set_table_dtype?)")
    dst.copy_(src)


def _restore_dense_optimizer(opt: torch.optim.Optimizer, saved: Dict) -> None:
    """Copy a saved ``state_dict()`` into ``opt``'s per-parameter state, in
    place where the live state already has the tensor; the live
    hyperparameters stay."""
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
            opt.state[p] = {k: v.to(p.device if k != "step" or step_on_device else "cpu")
                            for k, v in saved["state"][i].items()}
            continue
        if set(live) != set(saved["state"][i]):
            raise ValueError(f"checkpoint dense optimizer state {sorted(saved['state'][i])} of "
                             f"parameter {i} does not match the live {sorted(live)} (another "
                             "optimizer or setting?)")
        for k, v in saved["state"][i].items():
            _copy_into(live[k], v, f"dense optimizer state {k!r} of parameter {i}")


def restore_checkpoint(path: str, seq: nn.Module, state: TrainState) -> TrainState:
    """Restore a checkpoint of :func:`save_checkpoint` into ``seq`` and
    ``state``, in place; returns ``state``.

    The pipeline must be built as for the saved run (same model, inputs and
    optimizer).  A checkpoint of the sparse route cannot restore onto the
    dense route, nor the reverse: their optimizer states differ in layout,
    and this raises ``ValueError`` naming ``set_sparse_embeddings``.
    """
    t0 = time.perf_counter()
    saved = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if saved.get("format") != FORMAT:
        raise ValueError(f"{path!r} is not a checkpoint of this format (format "
                         f"{saved.get('format')!r}, expected {FORMAT})")
    hybrid = is_hybrid_opt_state(state.opt_state)
    if bool(saved["sparse"]) != hybrid:
        raise ValueError(
            f"checkpoint {path!r} was saved on the {'sparse' if saved['sparse'] else 'dense'} "
            f"embedding route but this trainer runs the {'sparse' if hybrid else 'dense'} one; "
            "the optimizer-state layouts are incompatible: set "
            "Pipeline.set_sparse_embeddings to match the checkpoint (or retrain)")
    named = dict(seq.named_parameters())
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
            _copy_into(named[name], value, f"parameter {name!r}")
        for name, value in saved_buffers.items():
            _copy_into(buffers[name], value, f"buffer {name!r}")
        _restore_dense_optimizer(_dense_optimizer(state), saved["dense_opt"])
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
                    _copy_into(live_slots[table][k], v, f"row slot {k!r} of {table!r}")
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
