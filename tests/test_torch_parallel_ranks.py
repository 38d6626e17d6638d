"""Rank code of the parallel tests (``test_torch_parallel*.py``), free of JAX.

:func:`spawn` starts a gloo world of CPU ranks, each a fresh interpreter
running this file on a job: a list of tasks (functions of this module) with
their arguments, pickled.  Each rank brings the process group up over a
``file://`` address in the test's directory, runs the tasks in order and
pickles its results; the test holds them against the JAX package.  Nothing
here imports JAX or the JAX package; the test files that do never run in a
rank.
"""

import os
import pickle
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn(tmp_path, world: int, tasks, env=None, timeout: int = 300):
    """Run ``tasks`` (``[(name, function name, kwargs), ...]``) in a world of
    ``world`` gloo ranks; returns each rank's ``{name: result}``.  ``env``:
    per rank, extra environment variables."""
    job = os.path.join(str(tmp_path), "job.pkl")
    with open(job, "wb") as f:
        pickle.dump({"world": world, "init": os.path.join(str(tmp_path), "init"),
                     "out": str(tmp_path), "tasks": tasks}, f)
    procs = []
    for r in range(world):
        rank_env = {**os.environ, **((env or {}).get(r, {}))}
        for k in ("MASTER_ADDR", "MASTER_PORT", "TORCHELASTIC_RUN_ID"):
            rank_env.pop(k, None)
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), job, str(r)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      env=rank_env, cwd=REPO))
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


# ---- helpers the tasks share ------------------------------------------------

def _mesh(shape):
    from torecsys_tpu_torch.parallel import make_mesh

    return make_mesh(*shape, device_type="cpu")


def build_pipeline(spec):
    """A CPU pipeline from a spec: ``fields``, ``embed``, ``num_dense``,
    ``model``, ``kwargs``, ``optimizer`` (name, lr[, keywords]), ``sparse``,
    ``table`` (``fused`` or ``field_aware``) and ``regularizer`` (its
    keywords); ``objective`` ``ltr`` builds :func:`ranking_pipeline`."""
    from torecsys_tpu_torch import Inputs, Pipeline, ValueInput
    from torecsys_tpu_torch.inputs import MultiIndicesEmbedding, MultiIndicesFieldAwareEmbedding

    if spec.get("objective", "ctr") != "ctr":
        return ranking_pipeline(spec)
    fields = tuple(spec["fields"])
    cats = tuple(f"cat_{i}" for i in range(len(fields)))
    schema = {}
    if spec.get("num_dense"):
        schema["feat_inputs"] = ValueInput(tuple(f"dense_{j}" for j in range(spec["num_dense"])))
    if spec.get("table", "fused") == "field_aware":
        schema["field_emb_inputs"] = MultiIndicesFieldAwareEmbedding(spec["embed"], fields, cats,
                                                                     device="cpu")
    else:
        schema["emb_inputs"] = MultiIndicesEmbedding(spec["embed"], fields, cats, device="cpu")
    name, lr, *kw = spec["optimizer"]
    pipe = (Pipeline(device="cpu").set_objective("ctr").set_inputs(Inputs(schema))
            .set_model(spec["model"], **spec.get("kwargs", {}))
            .set_criterion("BCEWithLogitsLoss").set_optimizer(name, lr=lr, **(kw[0] if kw else {}))
            .set_sparse_embeddings(spec.get("sparse")).set_target_fields("label"))
    if spec.get("regularizer") is not None:
        pipe.set_regularizer(**spec["regularizer"])
    return pipe


def ranking_pipeline(spec):
    """The ``ltr`` pipeline of a spec: ``fields`` (users, items) of one
    fused table at ``embed``, ``model`` and ``kwargs``, ``criterion``,
    ``num_negs`` negatives of the ``item`` field, ``optimizer`` (name,
    lr)."""
    from torecsys_tpu_torch import Inputs, Pipeline
    from torecsys_tpu_torch.inputs import MultiIndicesEmbedding

    name, lr = spec["optimizer"]
    table = MultiIndicesEmbedding(spec["embed"], tuple(spec["fields"]), ("user", "item"),
                                  device="cpu")
    return (Pipeline(device="cpu").set_objective("ltr").set_inputs(Inputs({"emb_inputs": table}))
            .set_model(spec["model"], **spec.get("kwargs", {}))
            .set_criterion(spec["criterion"]).set_optimizer(name, lr=lr)
            .set_miner("UniformBatchMiner", num_negs=spec["num_negs"])
            .set_miner_target_field("item").set_target_fields("label"))


def _layout_tuple(lay):
    return None if lay is None else (lay.rows, lay.shards, lay.index, lay.blocks)


def local_state(trainer):
    """This rank's parameters, row slots and dense optimizer state (``opt``:
    by parameter name and state key) as numpy, with the layout of each
    row-sharded table (``(rows, shards, index, blocks)``) and of each of its
    optimizer state tensors that holds its rows (``opt_layouts``; None for
    a reduced one)."""
    from torecsys_tpu_torch.parallel.sharding import _table_owners, axis_layout
    from torecsys_tpu_torch.train.optimizers import state_row_axis
    from torecsys_tpu_torch.train.sparse import is_hybrid_opt_state
    from torecsys_tpu_torch.train.state import batch_stats

    seq = trainer.pipeline.sequential
    out = {"params": {n: p.detach().numpy().copy() for n, p in seq.named_parameters()},
           "buffers": {n: b.numpy().copy() for n, b in batch_stats(seq).items()},
           "slots": {}, "layouts": {}, "opt": {}, "opt_layouts": {}}
    opt = trainer.state.opt_state
    if is_hybrid_opt_state(opt):
        out["slots"] = {t: {k: v.numpy().copy() for k, v in s.items()}
                        for t, s in opt["sparse"].items()}
        opt = opt["dense"]
    layouts = {}
    for name, m in _table_owners(seq).items():
        lay = m.row_layout
        if lay is not None:
            out["layouts"][name] = _layout_tuple(lay)
            layouts[name] = lay
    for name, p in seq.named_parameters():
        state = {k: v for k, v in opt.state.get(p, {}).items() if hasattr(v, "numpy")}
        out["opt"][name] = {k: v.detach().float().numpy().copy() for k, v in state.items()}
        out["opt_layouts"][name] = {
            k: _layout_tuple(axis_layout(layouts[name], state_row_axis(opt, p, k, v))
                             if name in layouts else None) for k, v in state.items()}
    return out


# ---- tasks ------------------------------------------------------------------

def mesh_task(shape):
    """The mesh of ``shape``: its shape, this rank's coordinate, the ranks of
    its two groups, the default mesh at the same table axis, and the errors
    of two meshes that do not fit the world."""
    import torch.distributed as dist

    from torecsys_tpu_torch.parallel.mesh import make_mesh

    mesh = _mesh(shape)
    errors = {}
    for args in ((-1, 3), (3, 2)):
        try:
            make_mesh(*args, device_type="cpu")
        except ValueError as e:
            errors[args] = str(e)
    return {"shape": dict(mesh.shape), "coordinate": mesh.coordinate, "errors": errors,
            "table_group": dist.get_process_group_ranks(mesh.group("table")),
            "data_group": dist.get_process_group_ranks(mesh.group("data")),
            "default": dict(make_mesh(table=shape[1], device_type="cpu").shape)}


def lookup_task(mesh_shape, table, ids, w, strategy, packed, capacity_factor, shard):
    """One sharded lookup and its gradient: ``sum(w * lookup)`` backward.
    ``shard``: hold the table row-sharded (as placement would) when its
    stored rows divide the table axis, else a full copy."""
    import torch

    from torecsys_tpu_torch.ops.embedding import pack_table
    from torecsys_tpu_torch.parallel import lookup as L
    from torecsys_tpu_torch.parallel.sharding import local_shard, shard_batch, table_layout

    mesh = _mesh(mesh_shape)
    ts = mesh.shape["table"]
    ctx = L.LookupContext(mesh=mesh, strategy=strategy, capacity_factor=capacity_factor,
                          min_rows_to_shard=0)
    e = table.shape[1]
    stored = pack_table(torch.tensor(table)) if packed else torch.tensor(table)
    layout = None
    if shard and stored.shape[0] % ts == 0 and ts > 1:
        layout = table_layout(tuple(stored.shape), ("table", None), mesh)
        stored = local_shard(stored, layout).clone()
    stored.requires_grad_(True)
    part = shard_batch({"ids": ids, "w": w}, mesh)
    fn = {"psum": L.sharded_packed_lookup,
          "alltoall": L.sharded_packed_lookup_alltoall}[strategy]
    out = fn(stored, torch.tensor(part["ids"]), e, ctx, layout)
    (out * torch.tensor(part["w"])).sum().backward()
    return {"out": out.detach().numpy(), "grad": stored.grad.numpy(),
            "coordinate": mesh.coordinate, "sharded": layout is not None}


def row_update_task(mesh_shape, rule, table, slots, uids, gsum, step):
    """``sharded_row_update`` of a row rule on this rank's shard (a table
    whose stored rows do not divide the table axis stays whole, and takes
    the whole-table update, as placement leaves it replicated)."""
    import torch

    from torecsys_tpu_torch.ops.sparse import RowAdagrad, RowAdam, RowSGD, sharded_row_update
    from torecsys_tpu_torch.parallel.sharding import local_shard, table_layout

    mesh = _mesh(mesh_shape)
    row_tx = {"adam": RowAdam(learning_rate=0.01, weight_decay=1e-3),
              "adagrad": RowAdagrad(learning_rate=0.05), "sgd": RowSGD(learning_rate=0.1)}[rule]
    ts = mesh.shape["table"]
    tbl = torch.tensor(table)
    slots_t = {k: torch.tensor(v) for k, v in slots.items()}
    args = (torch.tensor(uids), torch.tensor(gsum), torch.tensor(step, dtype=torch.int32))
    if tbl.shape[0] % ts == 0:
        layout = table_layout(tuple(tbl.shape), ("table", None), mesh)
        tbl = local_shard(tbl, layout).clone()
        slots_t = {k: local_shard(v, layout).clone() for k, v in slots_t.items()}
        sharded_row_update(row_tx, tbl, slots_t, *args, layout)
    else:
        row_tx.update(tbl, slots_t, *args)
    return {"table": tbl.numpy(), "slots": {k: v.numpy() for k, v in slots_t.items()},
            "coordinate": mesh.coordinate, "sharded": tbl.shape[0] != table.shape[0]}


def trainer_task(mesh_shape, spec, batches, states=None, lookup_options=None, presort=None,
                 lookup_recovery=True, fit_batches=None, final_state=None, free_from=None,
                 eval_batches=None):
    """The Trainer under the mesh.  With ``states`` (the JAX mesh Trainer's
    state before each batch: params, optimizer state, running statistics):
    each step from the JAX state, its loss and this rank's state after it.
    With ``free_from`` (a params tree) instead: from those parameters and a
    fresh optimizer state, a step a batch, each loss and state after it.
    With ``final_state``: from it, ``predict`` of the first batch and
    ``evaluate`` over the batches, or ``eval_batches`` (the global scores
    and metrics).  With ``fit_batches``: ``fit`` over them, its metrics, the
    recovery actions and the state after it."""
    from torecsys_tpu_torch import Trainer
    from torecsys_tpu_torch.convert import from_flax_params

    mesh = _mesh(mesh_shape)
    trainer = Trainer(build_pipeline(spec), mesh=mesh, presort=presort, log_every=1,
                      lookup_options=lookup_options, lookup_recovery=lookup_recovery)
    trainer.init_state()
    out = {"losses": [], "states": [], "coordinate": mesh.coordinate,
           "presorted": trainer._presorter is not None}
    if free_from is not None:
        from_flax_params(trainer.pipeline.sequential, free_from)
    for i, batch in enumerate(batches if free_from is not None else ()):
        out["losses"].append(float(trainer.train_steps([batch])[0]))
        out["states"].append(local_state(trainer))
    for batch, st in zip(batches, states or ()):
        from_flax_params(trainer.pipeline.sequential, st["params"], st["opt_state"],
                         trainer.state, batch_stats=st.get("batch_stats") or None)
        out["losses"].append(float(trainer.train_steps([batch])[0]))
        out["states"].append(local_state(trainer))
    if final_state is not None:
        from_flax_params(trainer.pipeline.sequential, final_state["params"],
                         batch_stats=final_state.get("batch_stats") or None)
        out["predict"] = trainer.predict(batches[0]).numpy()
        out["evaluate"] = trainer.evaluate(eval_batches or batches)
    if fit_batches is not None:
        try:
            out["metrics"] = trainer.fit(lambda: iter(fit_batches), max_epochs=1)
        except RuntimeError as e:
            out["error"] = f"{type(e).__name__}: {e}"
        out["recoveries"] = list(trainer.recoveries)
        out["capacity_factor"] = trainer.lookup_options.get("capacity_factor")
        out["state"] = local_state(trainer)
    return out


def carry_task(mesh_shape, spec, state, lookup_options=None):
    """This rank's state right after ``convert.from_flax_params`` carried
    the JAX state (params and optimizer state) into the mesh Trainer."""
    from torecsys_tpu_torch import Trainer
    from torecsys_tpu_torch.convert import from_flax_params

    trainer = Trainer(build_pipeline(spec), mesh=_mesh(mesh_shape), log_every=10**9,
                      lookup_options=lookup_options)
    trainer.init_state()
    from_flax_params(trainer.pipeline.sequential, state["params"], state["opt_state"],
                     trainer.state)
    return local_state(trainer)


def reductions_task(mesh_shape, spec, lookup_options=None):
    """The mesh's maximum over the table group and its byte count; which
    sharded tables a named written-out optimizer reduces over; and the
    warning an opaque factory's optimizer gets on a sharded table."""
    import logging

    import torch

    from torecsys_tpu_torch import Trainer

    mesh = _mesh(mesh_shape)
    t = torch.tensor([float(mesh.rank), -float(mesh.rank)])
    out = {"max": mesh.all_reduce(t, "table", op="max").tolist(), "sent": dict(mesh.sent)}
    named = Trainer(build_pipeline(spec), mesh=mesh, lookup_options=lookup_options)
    named.init_state()
    out["reduced"] = sorted(n for n, p in named.pipeline.sequential.named_parameters()
                            if p in named.state.opt_state._tables)
    records = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(record.getMessage())
    logger = logging.getLogger("torecsys_tpu_torch.train.trainer")
    logger.addHandler(handler)
    try:
        pipe = build_pipeline(spec).set_optimizer(
            lambda params: torch.optim.SGD(params, lr=0.1, momentum=0.9))
        opaque = Trainer(pipe, mesh=mesh, lookup_options=lookup_options)
        opaque.init_state()
    finally:
        logger.removeHandler(handler)
    out["warnings"] = records
    out["opaque"] = type(opaque.state.opt_state).__name__
    return out


def poison_task(mesh_shape, spec, batch, lookup_options):
    """One step under an overflowing all-to-all: the loss and each rank's
    lookup output slice, NaN where its bucket overflowed."""
    import torch

    from torecsys_tpu_torch import Trainer
    from torecsys_tpu_torch.parallel import lookup as L
    from torecsys_tpu_torch.parallel.sharding import shard_batch

    mesh = _mesh(mesh_shape)
    trainer = Trainer(build_pipeline(spec), mesh=mesh, log_every=10**9,
                      lookup_options=lookup_options, lookup_recovery=False)
    trainer.init_state()
    loss = float(trainer.train_steps([batch])[0])
    module = trainer.pipeline.sequential.inputs.schema["emb_inputs"]
    ids = torch.tensor(shard_batch(batch, mesh)["cat_0"]).to(torch.int64)[:, None]
    with L.use_sharded_lookup(mesh, **lookup_options), torch.no_grad():
        rows = module.embed(ids)
    return {"loss": loss, "rows": rows.numpy(), "coordinate": mesh.coordinate}


def checkpoint_task(spec, batches, directory):
    """Save at (2, 2) after two steps; restore at (2, 2), (1, 4) and on one
    device (rank 0); then a run of two epochs straight against one of an
    epoch, a checkpoint and a resumed epoch, at (2, 2)."""
    from torecsys_tpu_torch import Trainer
    from torecsys_tpu_torch.parallel.mesh import world

    rank = world()[0]
    opts = {"min_rows_to_shard": 0}
    saved = Trainer(build_pipeline(spec), mesh=_mesh((2, 2)), lookup_options=opts,
                    log_every=10**9)
    saved.train_steps(batches[:2])
    path = saved.save_checkpoint(os.path.join(directory, "ckpt_2.pt"))
    out = {"saved": local_state(saved), "files": sorted(os.listdir(directory))}
    import torch.distributed as dist

    dist.barrier()  # every rank has listed the files before rank 0 adds one
    for key, shape in (("same", (2, 2)), ("other", (1, 4))):
        t = Trainer(build_pipeline(spec), mesh=_mesh(shape), lookup_options=opts,
                    load_from=path, log_every=10**9)
        t.init_state()
        out[key] = local_state(t)
        out[f"{key}_step"] = int(t.state.step)
    single_path = os.path.join(directory, "single.pt")
    if rank == 0:
        t = Trainer(build_pipeline(spec), load_from=path, log_every=10**9)
        t.init_state()
        out["single"] = local_state(t)
        t.save_checkpoint(single_path)  # the single-device format
    import torch.distributed as dist

    dist.barrier()
    t = Trainer(build_pipeline(spec), mesh=_mesh((2, 2)), lookup_options=opts,
                load_from=single_path, log_every=10**9)
    t.init_state()
    out["from_single"] = local_state(t)
    straight = Trainer(build_pipeline(spec), mesh=_mesh((2, 2)), lookup_options=opts,
                       log_every=10**9)
    straight.fit(lambda: iter(batches), max_epochs=2)
    run_dir = os.path.join(directory, "run")
    first = Trainer(build_pipeline(spec), mesh=_mesh((2, 2)), lookup_options=opts,
                    checkpoint_dir=run_dir, log_every=10**9)
    first.fit(lambda: iter(batches), max_epochs=1)
    resumed = Trainer(build_pipeline(spec), mesh=_mesh((2, 2)), lookup_options=opts,
                      checkpoint_dir=run_dir, log_every=10**9)
    resumed.init_state()
    out["resumed_from"] = int(resumed.state.step)
    resumed.fit(lambda: iter(batches), max_epochs=1)
    out["straight"] = local_state(straight)
    out["resumed"] = local_state(resumed)
    return out


def node_slice_task(half_batches, sizes, sample, hash_size):
    """On a world of one rank a node (``LOCAL_WORLD_SIZE=1``): each rank
    loads only its own half of every batch, trains FM at 2 steps a
    dispatch on a (2, 1) mesh, then streams its node's chunks of a Criteo
    file; returns the parameters' digest and the stream's batch count."""
    from torecsys_tpu_torch import Trainer
    from torecsys_tpu_torch.data.streaming import CriteoFileIterable
    from torecsys_tpu_torch.parallel.mesh import multi_node, world

    assert multi_node()
    rank = world()[0]
    spec = {"fields": sizes, "embed": 4, "num_dense": 1, "model": "FM",
            "optimizer": ("Adam", 0.01)}
    mesh = _mesh((2, 1))
    trainer = Trainer(build_pipeline(spec), mesh=mesh, steps_per_execution=2, log_every=1000)
    metrics = trainer.fit(lambda: iter(half_batches[rank]), max_epochs=1)
    digest = float(sum(p.detach().double().sum() for p in trainer.pipeline.sequential.parameters()))
    stream = CriteoFileIterable(sample, hash_sizes=(hash_size,) * 26, batch_size=64)
    stream.chunk_bytes = 1 << 14
    spec_s = {"fields": (hash_size,) * 26, "embed": 4, "num_dense": 13, "model": "FM",
              "optimizer": ("Adam", 0.01)}
    t_s = Trainer(build_pipeline(spec_s), mesh=mesh, log_every=1000)
    m_s = t_s.fit(stream, max_epochs=1)
    return {"digest": digest, "loss": metrics["train_loss"], "stream_loss": m_s["train_loss"],
            "shard": (stream.shard_index, stream.num_shards), "counts": stream.shard_batch_counts(),
            "presorted": trainer._presorter is not None}


def cli_task(argv):
    """The CLI's ``train`` under the world's process group: its metrics and
    what this rank printed."""
    import contextlib
    import io

    from torecsys_tpu_torch.cli import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        trainer = run(argv)
    return {"printed": buf.getvalue(), "mesh": dict(trainer.mesh.shape),
            "step": int(trainer.state.step), "state": local_state(trainer)}


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


def assemble(states, name, slot=None, opt=None):
    """A global array from the ranks' :func:`local_state` records: parameter
    ``name``, or with ``slot`` that row slot of table ``name``, or with
    ``opt`` that key of its dense optimizer state.  A row-sharded tensor's
    shards are put back at their rows (each table rank once; the ranks of
    other data slices must hold the same), as ``(blocks, rows per block,
    ...)`` for the caller to reshape; anything else is rank 0's copy (a
    reduced optimizer state tensor, which is written once, must be every
    rank's to the bit)."""
    if opt is not None:
        pick = lambda s: s["opt"][name][opt]  # noqa: E731
        layout = states[0]["opt_layouts"][name][opt]
        layout_of = lambda s: s["opt_layouts"][name][opt]  # noqa: E731
    else:
        pick = ((lambda s: s["params"][name]) if slot is None
                else (lambda s: s["slots"][name][slot]))
        layout = states[0]["layouts"].get(name)
        layout_of = lambda s: s["layouts"][name]  # noqa: E731
    if layout is None:
        for s in states[1:] if opt is not None else ():
            np.testing.assert_array_equal(pick(s), pick(states[0]), err_msg=f"{name} {opt}")
        return pick(states[0])
    rows, shards, _, blocks = layout
    per = rows // blocks // shards
    parts = {}
    for s in states:
        local = pick(s)
        k = next(k for k in range(1, local.ndim + 1)
                 if int(np.prod(local.shape[:k])) == blocks * per)
        local = local.reshape(blocks, per, *local.shape[k:])
        t = layout_of(s)[2]
        if t in parts:
            np.testing.assert_array_equal(parts[t], local)
        parts[t] = local
    return np.concatenate([parts[t] for t in range(shards)], axis=1)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
