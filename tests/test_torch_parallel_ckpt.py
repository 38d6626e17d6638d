"""Checkpoints under a mesh, the distributed bring-up, the CLI's mesh
options and the example (``tests/test_multihost.py``'s twins and the rest
of the parallel slice).

* A checkpoint saved at (2, 2) (each rank's shards and a manifest) restores
  the same logical state (parameters, row slots, the dense optimizer's
  state) at (2, 2), at (1, 4) and on one device, and a single-device
  checkpoint restores into (2, 2); a resumed run continues as an unbroken
  one does, on the sparse and the dense route, and on the dense route under
  Adafactor and SM3, whose state holds tensors of other shapes than the
  table's: the factor along the rows and SM3's row vector are sharded with
  the table, the factor across the rows and SM3's column vector are
  reduced, the same on every rank, and written once.
* A JAX mesh Trainer's Adafactor and SM3 state carries into the shards of
  (2, 2) and (1, 4) (``convert.from_flax_params``) to the bit.
* ``initialize_distributed`` does nothing without a cluster environment and
  propagates a bad address; a world of one rank a node, each loading only
  its own slice, trains the same model on both ranks.
* ``train --data_parallel 2 --table_parallel 2`` in a gloo world of four.
* The example twin at a small size."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist

from test_torch_parallel_ranks import REPO, assemble, spawn
from torecsys_tpu_torch.cli import run
from torecsys_tpu_torch.data import make_synthetic_ctr
from torecsys_tpu_torch.parallel.mesh import initialize_distributed

FIELDS = (1000, 500, 200, 100, 64, 24)  # 236 stored rows: shards at 2 and 4
SPEC = {"fields": FIELDS, "embed": 16, "num_dense": 4, "model": "DeepFM",
        "kwargs": {"deep_layer_sizes": (16,)}, "optimizer": ("Adam", 1e-3), "sparse": True}
ROUTES = {"sparse": SPEC, "dense": {**SPEC, "sparse": False},
          # 236 stored rows of 128: factored (v_row (128,), v_col (236,)) as
          # the logical table is; 118 rows a shard at (2, 2), 59 at (1, 4)
          "adafactor": {**SPEC, "sparse": False, "optimizer": ("adafactor", 1e-2)},
          "sm3": {**SPEC, "sparse": False, "optimizer": ("sm3", 1e-2)}}
CARRIED = ("adafactor", "sm3")
CARRY_SHAPES = ((2, 2), (1, 4))
SAMPLE = os.path.join(REPO, "torecsys_tpu", "data", "sample", "criteo_sample.tsv")


def _batches(n=4, rows=256):
    data = make_synthetic_ctr(num_rows=rows * n, field_sizes=FIELDS, num_dense=4, seed=1)
    return [{k: v[i * rows:(i + 1) * rows] for k, v in data.items()} for i in range(n)]


@pytest.fixture(scope="module")
def jax_states():
    """The JAX mesh Trainer's state at (2, 2) after two steps, under each
    optimizer of :data:`CARRIED`."""
    from test_torch_parallel_optim import jax_steps

    return {name: jax_steps(ROUTES[name], (2, 2), _batches(n=3))[1][-1] for name in CARRIED}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory, jax_states):
    tasks = []
    for route, spec in ROUTES.items():
        directory = tmp_path_factory.mktemp(f"ckpt_{route}")
        tasks.append((route, "checkpoint_task", dict(spec=spec, batches=_batches(),
                                                     directory=str(directory))))
    for name in CARRIED:
        for shape in CARRY_SHAPES:
            tasks.append(((name, shape), "carry_task", dict(
                mesh_shape=shape, spec=ROUTES[name], state=jax_states[name],
                lookup_options={"min_rows_to_shard": 0})))
    return spawn(tmp_path_factory.mktemp("ckpt_world"), 4, tasks)


def _logical(states):
    """Every parameter, row slot and dense optimizer state tensor of the
    ranks' states, assembled."""
    s0 = states[0]
    out = {n: assemble(states, n) for n in s0["params"]}
    for table, slots in s0["slots"].items():
        for k in slots:
            out[f"{table}/{k}"] = assemble(states, table, k)
    for name, state in s0["opt"].items():
        for k in state:
            out[f"{name}:{k}"] = assemble(states, name, opt=k)
    return out


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.reshape(a[k], np.shape(b[k])), b[k], err_msg=k)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_a_mesh_checkpoint_restores_the_same_logical_state_anywhere(checkpoints, route):
    results = [r[route] for r in checkpoints]
    assert results[0]["files"] == ["ckpt_2.pt", "ckpt_2.pt.shard0", "ckpt_2.pt.shard1"]
    saved = _logical([r["saved"] for r in results])
    assert results[0]["saved"]["layouts"]  # the table was row-sharded
    for key in ("same", "other"):
        assert {r[f"{key}_step"] for r in results} == {2}
        _assert_same(_logical([r[key] for r in results]), saved)
    single = results[0]["single"]
    assert not single["layouts"]
    _assert_same(_logical([single]), saved)
    _assert_same(_logical([r["from_single"] for r in results]), saved)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_a_resumed_mesh_run_continues_as_an_unbroken_one(checkpoints, route):
    results = [r[route] for r in checkpoints]
    assert {r["resumed_from"] for r in results} == {4}
    _assert_same(_logical([r["resumed"] for r in results]),
                 _logical([r["straight"] for r in results]))


@pytest.mark.parametrize("shape", CARRY_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", CARRIED)
def test_a_jax_mesh_state_carries_into_the_shards(checkpoints, jax_states, name, shape):
    """Each rank takes its rows of the JAX state's row-indexed tensors and
    the reduced ones whole: put back together, the port's state is the JAX
    state to the bit, the parameters and every optimizer state tensor."""
    from test_torch_parallel_optim import jax_opt_tensors
    from torecsys_tpu_torch.convert import flatten, torch_name

    states = [r[(name, shape)] for r in checkpoints]
    assert states[0]["layouts"]  # the table is row-sharded
    want = jax_states[name]
    for path, ref in flatten(want["params"]).items():
        ref = np.asarray(ref)
        ref = ref.T if path.endswith("kernel") else ref
        np.testing.assert_array_equal(assemble(states, torch_name(path)).reshape(ref.shape), ref)
    port_keys = {n: set(s) for n, s in states[0]["opt"].items()}
    tensors, count = jax_opt_tensors(want["opt_state"], port_keys)
    assert {(n, k) for n, keys in port_keys.items() for k in keys if k != "step"} == set(tensors)
    table = "inputs.schema.emb_inputs.embedding"
    assert any(states[0]["opt_layouts"][table][k] is None for k in port_keys[table])
    for (n, k), ref in tensors.items():
        np.testing.assert_array_equal(assemble(states, n, opt=k).reshape(ref.shape), ref,
                                      err_msg=f"{n} {k}")


def test_initialize_distributed_is_a_no_op_without_a_cluster(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "TORCHELASTIC_RUN_ID"):
        monkeypatch.delenv(k, raising=False)
    initialize_distributed()
    initialize_distributed(device_type="cpu")
    assert not dist.is_initialized()


def test_initialize_distributed_propagates_a_bad_address():
    """An explicit address where nothing listens raises, rather than
    training alone where a cluster was asked for (port 1 of this host: the
    rank connects as a client and times out after 3 s)."""
    with pytest.raises(Exception, match="timed out"):
        initialize_distributed(init_method="tcp://127.0.0.1:1", world_size=2, rank=1,
                               backend="gloo", device_type="cpu", timeout=3)
    assert not dist.is_initialized()


def test_one_rank_a_node_each_loading_its_own_slice_trains_one_model(tmp_path):
    """Two ranks, one a node (``LOCAL_WORLD_SIZE=1``), each loading its own
    half of every batch (the presort off): the same parameters on both, as
    the JAX package's two processes.  Each then streams its node's chunks
    of the Criteo sample, both truncated to the same batch count."""
    sizes = (40, 20)
    data = make_synthetic_ctr(num_rows=512, field_sizes=sizes, num_dense=1, seed=7)
    halves = []
    for pid in (0, 1):
        half = {k: v[pid * 256:(pid + 1) * 256] for k, v in data.items()}
        halves.append([{k: v[s:s + 64] for k, v in half.items()} for s in range(0, 256, 64)])
    env = {r: {"LOCAL_WORLD_SIZE": "1", "WORLD_SIZE": "2", "RANK": str(r)} for r in (0, 1)}
    res = spawn(tmp_path, 2, [("node", "node_slice_task", dict(
        half_batches=halves, sizes=sizes, sample=SAMPLE, hash_size=50))], env=env)
    a, b = res[0]["node"], res[1]["node"]
    assert abs(a["digest"] - b["digest"]) < 1e-4 and a["loss"] == b["loss"]
    assert np.isfinite(a["loss"]) and np.isfinite(a["stream_loss"])
    assert (a["shard"], b["shard"]) == ((0, 2), (1, 2))
    assert a["counts"] == b["counts"] and not a["presorted"]


CLI_ARGS = ["train", "--device", "cpu", "--model_config",
            '{"method": "DeepFM", "deep_layer_sizes": [16]}', "--num_rows", "4096",
            "--batch_size", "512", "--max_num_epochs", "1", "--embed_size", "8"]


def test_cli_trains_on_a_mesh_and_only_rank_zero_prints(tmp_path, capsys):
    mesh_args = CLI_ARGS + ["--data_parallel", "2", "--table_parallel", "2",
                            "--min_rows_to_shard", "0", "--lookup_strategy", "psum"]
    res = spawn(tmp_path, 4, [("cli", "cli_task", {"argv": mesh_args})])
    single = run(CLI_ARGS)
    want = capsys.readouterr().out.strip().splitlines()[-1]
    for r, out in enumerate(res):
        cli = out["cli"]
        assert cli["mesh"] == {"data": 2, "table": 2}
        assert cli["step"] == int(single.state.step)
        assert ("train_loss" in cli["printed"]) == (r == 0)
    import json

    got, ref = json.loads(res[0]["cli"]["printed"].strip().splitlines()[-1]), json.loads(want)
    np.testing.assert_allclose(got["train_loss"], ref["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["val_auc"], ref["val_auc"], rtol=1e-4)


def test_the_example_twin_runs_on_a_cpu_mesh_of_eight():
    proc = subprocess.run([sys.executable, "-m", "torecsys_tpu_torch.examples.sharded_lookup",
                           "--device", "cpu", "--epochs", "1", "--num_rows", "4096"],
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "mesh: {'data': 2, 'table': 4}" in proc.stdout
    auc = float(proc.stdout.strip().splitlines()[-1].split()[-1])
    assert 0.5 < auc <= 1.0
