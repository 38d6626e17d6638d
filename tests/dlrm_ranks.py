"""Rank code of ``test_torch_dlrm_dcnv2.py``'s gloo worlds, free of JAX.

:func:`spawn` starts a world of CPU ranks, each a fresh interpreter running
this file on a pickled job of tasks (functions of this module) with their
arguments; each rank brings the process group up over a ``file://`` address
in the test's directory, runs the tasks in order and pickles its results.
The helpers build the tests' small DLRM-DCNv2 and move its state in and
out of the port as the plain reference's ``(p, v)`` dicts
(``plain_dlrm_dcnv2``): the logical ``(V, E)`` table and each dense
parameter, float64.
"""

import os
import pickle
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# 4 multi-hot fields of 60-2,000 rows at E = 8: 2,560 logical rows, 160
# stored rows of 16, which split over 2 and 4 table ranks
CFG = dict(field_sizes=(60, 200, 2000, 300), hots=(3, 1, 5, 2), embed=8, num_dense=3,
           bottom=(16,), cross_layers=2, cross_rank=4, top=(16, 8), lr=0.05, eps=1e-8,
           batch=32)
TABLE_PARAM = "inputs.schema.emb_inputs.embedding"


def spawn(tmp_path, world: int, tasks, timeout: int = 300):
    """Run ``tasks`` (``[(name, function name, kwargs), ...]``) in a world of
    ``world`` gloo ranks; returns each rank's ``{name: result}``."""
    job = os.path.join(str(tmp_path), "job.pkl")
    with open(job, "wb") as f:
        pickle.dump({"world": world, "init": os.path.join(str(tmp_path), "init"),
                     "out": str(tmp_path), "tasks": tasks}, f)
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "TORCHELASTIC_RUN_ID")}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), job, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                              cwd=REPO) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-6000:]}"
    results = []
    for r in range(world):
        with open(os.path.join(str(tmp_path), f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


# ---- the model, its batches and its state -----------------------------------

def batches(seed: int, n: int, batch: int = CFG["batch"]):
    """Host batches: ``cat_{i}`` ``(B, h_i)`` int32 ids (a one-hot field
    ``(B,)``), ``dense_{j}`` and ``label``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {}
        for i, (v, h) in enumerate(zip(CFG["field_sizes"], CFG["hots"])):
            ids = rng.integers(0, v, size=(batch, h)).astype(np.int32)
            b[f"cat_{i}"] = ids[:, 0] if h == 1 else ids
        for j in range(CFG["num_dense"]):
            b[f"dense_{j}"] = rng.normal(size=batch).astype(np.float32)
        b["label"] = (rng.uniform(size=batch) < 0.5).astype(np.float32)
        out.append(b)
    return out


def pipeline(sparse: bool, compute=None):
    from torecsys_tpu_torch import Inputs, Pipeline, ValueInput
    from torecsys_tpu_torch.inputs import MultiHotIndicesEmbedding

    fields = tuple(f"cat_{i}" for i in range(len(CFG["field_sizes"])))
    schema = {"feat_inputs": ValueInput(tuple(f"dense_{j}" for j in range(CFG["num_dense"]))),
              "emb_inputs": MultiHotIndicesEmbedding(CFG["embed"], CFG["field_sizes"],
                                                     CFG["hots"], fields, device="cpu")}
    return (Pipeline(device="cpu").set_objective("ctr").set_inputs(Inputs(schema))
            .set_model("DLRM_DCNv2", bottom_layer_sizes=CFG["bottom"],
                       cross_num_layers=CFG["cross_layers"], cross_rank=CFG["cross_rank"],
                       top_layer_sizes=CFG["top"])
            .set_criterion("BCEWithLogitsLoss")
            .set_optimizer("Adagrad", lr=CFG["lr"], initial_accumulator_value=0.0,
                           eps=CFG["eps"])
            .set_sparse_embeddings(sparse).set_compute_dtype(compute).set_target_fields("label"))


def _rows(trainer):
    """``(first logical row, logical rows)`` this rank holds of the table."""
    module = trainer.pipeline.sequential.inputs.schema["emb_inputs"]
    lay = module.row_layout
    pack = module.pack
    if lay is None:
        return 0, module.embedding.shape[0] * pack
    return lay.index * lay.shard_rows * pack, lay.shard_rows * pack


def _slots(trainer):
    """``{parameter name: its Adagrad accumulator}`` of either route."""
    seq = trainer.pipeline.sequential
    opt = trainer.state.opt_state
    named = dict(seq.named_parameters())
    dense = opt["dense"] if isinstance(opt, dict) else opt
    out = {n: dense.state[p]["sum_of_squares"] for n, p in named.items() if p in dense.state}
    if isinstance(opt, dict):
        out.update({n: s["v"] for n, s in opt["sparse"].items()})
    return out


def read_state(trainer):
    """This rank's ``(p, v)`` as float64 numpy: the table's rows it holds
    (logical, ``(rows, E)``) under ``table`` with ``table_first``, each
    dense parameter whole."""
    seq = trainer.pipeline.sequential
    e = CFG["embed"]
    first, n = _rows(trainer)
    p, v = {}, {}
    for name, param in seq.named_parameters():
        src, acc = param.detach(), _slots(trainer)[name]
        if name == TABLE_PARAM:
            p["table"] = src.reshape(-1, e)[:n].double().numpy().copy()
            v["table"] = acc.reshape(-1, e)[:n].double().numpy().copy()
            continue
        p[name] = src.double().numpy().copy()
        v[name] = acc.double().numpy().copy()
    return {"p": p, "v": v, "first": first}


def write_state(trainer, p, v) -> None:
    """Write the global ``(p, v)`` (numpy) into the port: the table's rows
    this rank holds, every dense parameter."""
    import torch

    seq = trainer.pipeline.sequential
    e = CFG["embed"]
    first, n = _rows(trainer)
    total = sum(CFG["field_sizes"])
    slots = _slots(trainer)
    with torch.no_grad():
        for name, param in seq.named_parameters():
            if name == TABLE_PARAM:
                for dst, src in ((param.detach().view(-1, e), p["table"]),
                                 (slots[name].view(-1, e), v["table"])):
                    dst.zero_()
                    hi = min(first + n, total)
                    if hi > first:
                        dst[:hi - first].copy_(torch.from_numpy(src[first:hi]))
                continue
            param.copy_(torch.from_numpy(p[name]))
            slots[name].copy_(torch.from_numpy(v[name]))


def logical_table(trainer):
    """This rank's rows of the logical table as float32 numpy, with the
    first's index and the table parameter's shape."""
    module = trainer.pipeline.sequential.inputs.schema["emb_inputs"]
    first, n = _rows(trainer)
    return {"rows": module.embedding.detach().reshape(-1, CFG["embed"])[:n].numpy().copy(),
            "first": first, "shape": tuple(module.embedding.shape)}


# ---- tasks --------------------------------------------------------------------

def _trainer(mesh_shape, sparse, seed=0):
    from torecsys_tpu_torch import Trainer
    from torecsys_tpu_torch.parallel import make_mesh

    mesh = make_mesh(*mesh_shape, device_type="cpu")
    trainer = Trainer(pipeline(sparse), mesh=mesh, seed=seed, log_every=10**9,
                      lookup_options={"strategy": "psum", "min_rows_to_shard": 0})
    trainer.init_state()
    return trainer


def held_steps_task(mesh_shape, sparse, batches, states):
    """One step from each of ``states`` (the plain reference's ``(p, v)``
    before each batch): the loss and this rank's state after it."""
    trainer = _trainer(mesh_shape, sparse)
    out = {"losses": [], "states": [], "coordinate": trainer.mesh.coordinate}
    for batch, st in zip(batches, states):
        write_state(trainer, st["p"], st["v"])
        out["losses"].append(float(trainer.train_steps([batch])[0]))
        out["states"].append(read_state(trainer))
    return out


def init_task(mesh_shape, seed):
    """This rank's rows of the logical table as the trainer draws them."""
    return logical_table(_trainer(mesh_shape, True, seed))


def refused_task(strategy):
    """The error a multi-hot lookup raises under ``strategy`` on a (1, 2)
    mesh."""
    from torecsys_tpu_torch import Trainer
    from torecsys_tpu_torch.parallel import make_mesh

    trainer = Trainer(pipeline(True), mesh=make_mesh(1, 2, device_type="cpu"), log_every=10**9,
                      lookup_options={"strategy": strategy, "min_rows_to_shard": 0})
    try:
        trainer.train_steps(batches(5, 1))
    except ValueError as e:
        return str(e)
    return None


def main(job_path: str, rank: int) -> None:
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(1)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    from torecsys_tpu_torch.parallel.mesh import initialize_distributed

    initialize_distributed(init_method="file://" + job["init"], world_size=job["world"],
                           rank=rank, backend="gloo", device_type="cpu", timeout=240)
    results = {}
    for name, fn, kwargs in job["tasks"]:
        results[name] = globals()[fn](**kwargs)
    with open(os.path.join(job["out"], f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
