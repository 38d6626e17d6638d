"""Meshes over ``torch.distributed`` (counterpart of ``torecsys_tpu/parallel/mesh.py``).

One rank holds one device.  A :class:`Mesh` lays the ranks of the process
group out as a ``(data, table)`` grid, rank ``r = d * table + t`` at
``(d, t)`` (as ``np.asarray(devices).reshape(data, table)`` lays out the
JAX package's devices), with the process group of each axis from
``torch.distributed.device_mesh``: the data group of a rank is its column
(the ranks of its ``t``, in ``d`` order), its table group its row.

The collectives of the sharded path go through the mesh
(:meth:`Mesh.all_reduce`, a sum or a maximum, :meth:`Mesh.all_gather`,
:meth:`Mesh.all_to_all`).
Over NCCL they take the card's tensors as they are.  Over gloo they take
CPU tensors; a card tensor under gloo (several ranks sharing one card, where
NCCL refuses to run) is copied to the host for the collective and back, so
every kernel still runs on the card and only the exchange goes through the
host.  A group of one rank is the identity.

The JAX package's processes are the port's nodes.  On one node (``WORLD_SIZE
== LOCAL_WORLD_SIZE``, or no launcher) every rank's loader yields the global
batch and each rank keeps its data slice (``sharding.shard_batch``).  On
several nodes each node's loader yields the node's share of the batch, as
each JAX process loads its own, and the node's ranks split it
(:func:`host_local_batch_to_global`).
"""

from __future__ import annotations

import datetime
import os
from collections import Counter
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from torecsys_tpu_torch.utils import trace

DATA_AXIS = "data"
TABLE_AXIS = "table"


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> tuple:
    """(rank, world size) of the default process group, (0, 1) without one."""
    if _initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_world_size() -> int:
    """Ranks on this node: ``LOCAL_WORLD_SIZE`` as a launcher sets it, else
    the whole world (one node)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world()[1]))


def multi_node() -> bool:
    """True when the world spans several nodes (``WORLD_SIZE >
    LOCAL_WORLD_SIZE``): the counterpart of the JAX package's
    ``jax.process_count() > 1``."""
    return world()[1] > local_world_size()


class Mesh:
    """A ``(data, table)`` grid of ranks and the process group of each axis.

    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh.shape``
    does; ``device`` is this rank's device (the card, or the CPU when the
    mesh was made with ``device_type="cpu"``); ``coordinate`` is this rank's
    ``(d, t)``, None for a rank outside a mesh smaller than the world.
    ``sent`` counts the bytes this rank handed each kind of collective
    (``all_reduce``, ``all_reduce_max``, ``all_gather``, ``all_to_all``)
    over groups of more than one rank, as it calls them (a captured graph's
    replays are not counted); with the trainer's tracer on, the same bytes
    go to its ``collective_bytes`` counter, which adds a captured graph's at
    each replay (``utils.trace``).
    """

    def __init__(self, data: int, table: int, device: torch.device,
                 axis_names: Sequence[str] = (DATA_AXIS, TABLE_AXIS), device_mesh=None):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = {self.axis_names[0]: data, self.axis_names[1]: table}
        self.device = device
        self.device_mesh = device_mesh
        self.rank, self.world_size = world()
        self.backend = dist.get_backend() if _initialized() else None
        n = data * table
        self.coordinate = (self.rank // table, self.rank % table) if self.rank < n else None
        self._groups = {}
        self.sent = Counter()
        if device_mesh is not None and self.coordinate is not None:
            for axis in self.axis_names:
                self._groups[axis] = device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at {self.coordinate}, "
                f"{self.device}, {self.backend})")

    @property
    def size(self) -> int:
        return self.shape[self.axis_names[0]] * self.shape[self.axis_names[1]]

    def index(self, axis: str) -> int:
        """This rank's position along ``axis``."""
        if self.coordinate is None:
            raise ValueError(f"rank {self.rank} is outside the mesh {self.shape}")
        return self.coordinate[self.axis_names.index(axis)]

    def group(self, axis: str):
        return self._groups.get(axis)

    # ---- collectives -------------------------------------------------------

    def _count(self, kind: str, n_bytes: int) -> None:
        self.sent[kind] += n_bytes
        trace.count("collective_bytes", n_bytes)

    def _staged(self, t: torch.Tensor) -> bool:
        """Whether a collective on ``t`` goes through the host (a card tensor
        under gloo)."""
        return self.backend == "gloo" and t.device.type != "cpu"

    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` over ``axis`` in place by ``op``, ``"sum"`` or
        ``"max"``; returns ``t``.  A maximum is counted in ``sent`` as
        ``all_reduce_max``."""
        if self.shape[axis] == 1:
            return t
        group = self.group(axis)
        reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        self._count("all_reduce" if op == "sum" else f"all_reduce_{op}",
                    t.numel() * t.element_size())
        if self._staged(t):
            host = t.cpu()
            dist.all_reduce(host, op=reduce_op, group=group)
            return t.copy_(host)
        dist.all_reduce(t, op=reduce_op, group=group)
        return t

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``(n, *t.shape)``: every rank's ``t`` along ``axis``, in the axis'
        order."""
        n = self.shape[axis]
        if n == 1:
            return t[None]
        group = self.group(axis)
        self._count("all_gather", t.numel() * t.element_size())
        src = t.contiguous().reshape(1, -1)
        staged = self._staged(src)
        if staged:
            src = src.cpu()
        out = src.new_empty((n, src.shape[1]))
        dist.all_gather_into_tensor(out, src, group=group)
        return out.to(t.device).reshape(n, *t.shape)

    def all_to_all(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``t`` of ``(n, ...)``: block ``i`` goes to the ``i``-th rank of
        ``axis``; returns ``(n, ...)`` whose block ``i`` came from it
        (``jax.lax.all_to_all(t, axis, 0, 0)``)."""
        n = self.shape[axis]
        if n == 1:
            return t.clone()
        group = self.group(axis)
        self._count("all_to_all", t.numel() * t.element_size())
        src = t.contiguous()
        if self._staged(src):
            host = src.cpu()
            out = torch.empty_like(host)
            dist.all_to_all_single(out, host, group=group)
            return out.to(t.device)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=group)
        return out

    def world_all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over every rank of the process group, in place."""
        if not _initialized() or self.world_size == 1:
            return t
        if self._staged(t):
            host = t.cpu()
            dist.all_reduce(host)
            return t.copy_(host)
        dist.all_reduce(t)
        return t


def _rank_device(device_type: str) -> torch.device:
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"make_mesh(device_type={device_type!r}): no CUDA device; pass "
                           "device_type='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def make_mesh(data: int = -1, table: int = 1, *, device_type: Optional[str] = None,
              axis_names: Sequence[str] = (DATA_AXIS, TABLE_AXIS)) -> Mesh:
    """Build a 2-D ``(data, table)`` mesh over the ranks of the process group.

    Args:
        data: size of the data-parallel axis; ``-1`` = all remaining ranks.
        table: size of the table (embedding row-shard) axis.
        device_type: ``"cuda"`` (the default: this rank's current card) or
            ``"cpu"``, as the tests ask.
        axis_names: the axis names; defaults to ``('data', 'table')``.

    Without a process group the world is one rank.  A mesh smaller than the
    world takes its first ``data * table`` ranks.
    """
    _, n = world()
    if data == -1:
        if n % table != 0:
            raise ValueError(f"{n} devices not divisible by table={table}")
        data = n // table
    if data * table > n:
        raise ValueError(f"mesh {data}x{table} needs {data * table} devices, have {n}")
    device_type = device_type or "cuda"
    device = _rank_device(device_type)
    device_mesh = None
    if _initialized():
        from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

        # The mesh's groups take the default group's backend; under gloo the
        # device mesh is made for the CPU, as gloo's collectives are, and the
        # port's card tensors are staged (Mesh._staged).
        mesh_type = "cpu" if dist.get_backend() == "gloo" else device_type
        names = tuple(axis_names)
        if data * table == n:
            device_mesh = init_device_mesh(mesh_type, (data, table), mesh_dim_names=names)
        else:
            device_mesh = DeviceMesh(mesh_type, torch.arange(data * table).reshape(data, table),
                                     mesh_dim_names=names)
    return Mesh(data, table, device, axis_names, device_mesh)


def initialize_distributed(**kwargs) -> None:
    """Bring the process group up: ``torch.distributed.init_process_group``.

    A deliberate no-op when a process group already exists, or when no
    cluster environment is there (no ``MASTER_ADDR``/``MASTER_PORT``/
    ``TORCHELASTIC_RUN_ID``, as ``torchrun`` sets them) and no explicit
    ``init_method`` was given: a single-rank run.  Every other failure
    propagates (a bad address, a partial world), because a rank that trained
    alone where a cluster was asked for would train its own copy.

    Keyword arguments go to ``init_process_group`` (``init_method``,
    ``world_size``, ``rank``, ``timeout`` in seconds or a ``timedelta``),
    and two more: ``backend`` (default NCCL when the card is there and
    ``device_type`` is not ``"cpu"``, else gloo) and ``device_type``.  On the
    card under a launcher the rank's device is set to ``LOCAL_RANK`` modulo
    the cards of the node before the group starts; without one the caller
    sets it.
    """
    if _initialized():
        return
    explicit = bool(kwargs.get("init_method"))
    auto_env = any(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT", "TORCHELASTIC_RUN_ID"))
    if not explicit and not auto_env:
        return
    kwargs = dict(kwargs)
    device_type = kwargs.pop("device_type", None)
    on_card = device_type != "cpu" and torch.cuda.is_available()
    backend = kwargs.pop("backend", None) or ("nccl" if on_card else "gloo")
    timeout = kwargs.pop("timeout", None)
    if timeout is not None:
        kwargs["timeout"] = (timeout if isinstance(timeout, datetime.timedelta)
                             else datetime.timedelta(seconds=float(timeout)))
    if on_card and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    dist.init_process_group(backend=backend, **kwargs)


def _node_slice(mesh: Mesh):
    """(parts, part) of this rank's data slice within its node's batch."""
    ts = mesh.shape[mesh.axis_names[1]]
    local = local_world_size()
    node = mesh.rank // local
    coords = sorted({r // ts for r in range(node * local, min((node + 1) * local, mesh.size))})
    d = mesh.index(mesh.axis_names[0])
    return len(coords), d - coords[0]


def host_local_batch_to_global(batch, mesh: Mesh, data_axis: str = DATA_AXIS,
                               stacked: bool = False):
    """This rank's part of a node-local batch.

    On several nodes each node loads only its share of the batch (per-node
    file sharding), as each JAX process loads its own; the node's ranks
    split it along the data axis as the node's devices split it there
    (``jax.make_array_from_process_local_data``).  With one rank a node and
    no table axis the batch is the rank's as it is.  ``stacked=True`` takes
    ``(K, B/node, ...)`` stacks, split on their second axis.
    """
    del data_axis
    parts, part = _node_slice(mesh)
    axis = 1 if stacked else 0
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        n = v.shape[axis]
        if n % parts:
            raise ValueError(f"batch field {k!r} of {n} rows does not split over the node's "
                             f"{parts} data slices")
        size = n // parts
        out[k] = v[(slice(None),) * axis + (slice(part * size, (part + 1) * size),)]
    return out


__all__ = ["DATA_AXIS", "TABLE_AXIS", "Mesh", "host_local_batch_to_global",
           "initialize_distributed", "make_mesh", "multi_node"]
