"""Row-sharded embedding tables on a ``(data, table)`` mesh (twin of
``examples/sharded_lookup.py``).

The fused embedding table is row-sharded over the ``table`` axis, batches
are split over ``data``, and the lookups route through the sharded
collectives: ``psum`` (contribute and reduce), ``alltoall`` (unique-id
exchange with a capacity factor) or ``auto`` (the calibrated byte model
picks per lookup).  The same Trainer code runs on one device or on a mesh.

On the CPU (``--device cpu``, no launcher) it starts a (2, 4) mesh of 8
gloo processes itself, the JAX example's 8 virtual devices.  On cards it
runs under ``torchrun`` with NCCL, one process a card:

    python -m torecsys_tpu_torch.examples.sharded_lookup --device cpu
    torchrun --nproc_per_node 4 -m torecsys_tpu_torch.examples.sharded_lookup \\
        --data 2 --table 2
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Optional, Sequence

import torch.distributed as dist

from torecsys_tpu_torch.data import make_synthetic_ctr
from torecsys_tpu_torch.inputs import Inputs, MultiIndicesEmbedding, ValueInput
from torecsys_tpu_torch.parallel import make_mesh
from torecsys_tpu_torch.parallel.mesh import initialize_distributed
from torecsys_tpu_torch.train import Pipeline, Trainer

FIELD_SIZES = (5000, 3000, 1000)


def main(epochs: int = 2, batch_size: int = 512, data: int = 2, table: int = 4,
         num_rows: int = 16_384, device: Optional[str] = None) -> float:
    """Train DeepFM on the mesh; returns the validation AUC (every rank's)."""
    rows = make_synthetic_ctr(num_rows=num_rows, field_sizes=FIELD_SIZES, num_dense=2)
    inputs = Inputs({
        "feat_inputs": ValueInput(("dense_0", "dense_1")),
        "emb_inputs": MultiIndicesEmbedding(16, FIELD_SIZES, ("cat_0", "cat_1", "cat_2"),
                                            device=device),
    })
    pipeline = (
        Pipeline(device=device)
        .set_objective("ctr")
        .set_inputs(inputs)
        .set_model("DeepFM", deep_layer_sizes=(32, 32))
        .set_criterion("BCEWithLogitsLoss")
        .set_optimizer("Adam", lr=0.01)
        .set_target_fields("label")
    )
    mesh = make_mesh(data=data, table=table, device_type="cpu" if device == "cpu" else "cuda")
    trainer = Trainer(
        pipeline,
        mesh=mesh,
        log_every=10_000,
        lookup_options={
            "min_rows_to_shard": 0,     # shard even this demo-sized table
            "strategy": "auto",         # psum vs alltoall from the byte model
            "capacity_factor": 2.0,
        },
    )

    def loader(lo, hi):
        def gen():
            for s in range(lo, hi - batch_size + 1, batch_size):
                yield {k: v[s:s + batch_size] for k, v in rows.items()}
        return gen

    split = num_rows * 7 // 8
    metrics = trainer.fit(loader(0, split), val_loader=loader(split, num_rows),
                          max_epochs=epochs)
    table_module = trainer.pipeline.inputs.schema["emb_inputs"]
    if mesh.rank == 0:
        layout = table_module.row_layout
        print(f"mesh: {mesh.shape}")
        # 9,000 rows pack into 1,125 stored rows: sharded where that divides
        # the table axis, else replicated with the lookups still collective
        print("table on rank 0: " + (f"rows {tuple(table_module.embedding.shape)} of "
                                     f"{layout.rows} stored rows" if layout is not None
                                     else f"replicated, {tuple(table_module.embedding.shape)}"))
        print(f"val AUC {metrics['val_auc']:.4f}")
    return metrics["val_auc"]


def _rank(rank: int, world: int, init: str, kwargs) -> None:
    import torch

    torch.set_num_threads(1)
    initialize_distributed(init_method=init, world_size=world, rank=rank, backend="gloo",
                           device_type="cpu")
    try:
        main(**kwargs)
    finally:
        dist.destroy_process_group()


def cli(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--data", type=int, default=2, help="data axis size")
    ap.add_argument("--table", type=int, default=4, help="table axis size")
    ap.add_argument("--num_rows", type=int, default=16_384)
    args = ap.parse_args(argv)
    kwargs = dict(epochs=args.epochs, data=args.data, table=args.table,
                  num_rows=args.num_rows, device=args.device)
    if "MASTER_ADDR" in os.environ or "TORCHELASTIC_RUN_ID" in os.environ:
        initialize_distributed(device_type="cpu" if args.device == "cpu" else "cuda")
        main(**kwargs)
        dist.destroy_process_group()
        return
    if args.device != "cpu":
        sys.exit("on cards, run under torchrun (see the module's docstring); "
                 "--device cpu starts its own gloo processes")
    import torch.multiprocessing as mp

    world = args.data * args.table
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(world, f"file://{os.path.join(tmp, 'init')}", kwargs),
                 nprocs=world, join=True)


if __name__ == "__main__":
    cli()
