"""Distributed execution on ``torch.distributed`` (counterpart of
``torecsys_tpu/parallel``): device meshes, sharding rules, sharded
embedding lookup.

* one ``(data, table)`` :class:`~torecsys_tpu_torch.parallel.mesh.Mesh` of
  ranks, one device a rank, with the process group of each axis;
* the batch is split over ``data`` (data parallelism for the dense towers:
  the train step sums their gradients over the data group);
* embedding tables are **row-sharded** over ``table``: each rank holds its
  rows as a plain tensor; lookups exchange rows through the table group's
  collectives (``psum`` or ``alltoall``), and the sparse update runs on each
  rank's own rows (``ops.sparse.sharded_row_update``);
* what the JAX package's step takes over a whole table or the whole batch
  is taken over the groups: a dense optimizer's norms, means and maxima of
  a sharded table (``train.optimizers``, ``Mesh.all_reduce`` sums and
  maxima), a regularizer's penalty of it and the in-batch miner's draws
  (``train.steps``).
"""

from torecsys_tpu_torch.parallel.lookup import (
    LookupContext,
    maybe_sharded_lookup,
    maybe_sharded_packed_lookup,
    sharded_lookup,
    sharded_lookup_alltoall,
    sharded_packed_lookup,
    sharded_packed_lookup_alltoall,
    use_sharded_lookup,
)
from torecsys_tpu_torch.parallel.mesh import DATA_AXIS, TABLE_AXIS, make_mesh
from torecsys_tpu_torch.parallel.sharding import (
    batch_sharding,
    infer_param_sharding,
    shard_batch,
    shard_params,
)

__all__ = [
    "DATA_AXIS",
    "TABLE_AXIS",
    "LookupContext",
    "batch_sharding",
    "infer_param_sharding",
    "make_mesh",
    "maybe_sharded_lookup",
    "maybe_sharded_packed_lookup",
    "shard_batch",
    "shard_params",
    "sharded_lookup",
    "sharded_lookup_alltoall",
    "sharded_packed_lookup_alltoall",
    "sharded_packed_lookup",
    "use_sharded_lookup",
]
