"""Checkpoints of the port (``torecsys_tpu_torch/train/checkpoint.py``) and the
Trainer's ``checkpoint_dir`` / ``load_from`` / ``resume``: a save and
restore round trip is bit-exact on the presorted, on-device and dense
routes (and on a bf16 table), and leaves every live tensor where it was;
N steps, a checkpoint, a fresh Trainer restored from it and M more steps
equal N + M steps straight through; ``latest_checkpoint``; ``load_from``
over auto-resume; the sparse/dense layout mismatch; a missing file.  The
same for xDeepFM, whose running statistics (the CIN's BatchNorm buffers)
are saved under ``buffers`` and restored to the bit, in place; and a
checkpoint of the format before ``buffers`` (none) still restores DeepFM."""

import os

import numpy as np
import pytest
import torch

from torecsys_tpu_torch import Inputs, MultiIndicesEmbedding, Pipeline, Trainer, ValueInput
from torecsys_tpu_torch.data import make_synthetic_ctr
from torecsys_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from torecsys_tpu_torch.train.steps import _held_tensors

FIELDS = (300, 50, 20, 7)
B = 64

# route: (sparse_embeddings, presort, table dtype)
ROUTES = {"presorted": (True, None, None), "ondevice": (True, False, None),
          "dense": (False, None, None), "dense_bf16_table": (False, None, "bfloat16")}


def _batches(n, seed=0):
    d = make_synthetic_ctr(num_rows=B * n, field_sizes=FIELDS, num_dense=3, seed=seed)
    return [{k: v[i * B:(i + 1) * B] for k, v in d.items()} for i in range(n)]


def _trainer(route, **kw):
    sparse, presort, table = ROUTES[route]
    inputs = Inputs({
        "feat_inputs": ValueInput(tuple(f"dense_{j}" for j in range(3))),
        "emb_inputs": MultiIndicesEmbedding(8, FIELDS, tuple(f"cat_{i}" for i in range(4)),
                                            device="cpu")})
    pipe = (Pipeline(device="cpu").set_inputs(inputs).set_model("DeepFM", deep_layer_sizes=(16,))
            .set_optimizer("Adam", lr=1e-2).set_sparse_embeddings(sparse).set_table_dtype(table))
    trainer = Trainer(pipe, presort=presort, seed=3, **kw)
    trainer.init_state()
    assert trainer.sparse == sparse
    assert (trainer._presorter is not None) == (route == "presorted")
    return trainer


def _held(trainer):
    return _held_tensors(trainer.pipeline.sequential, trainer.state)


def _bits(t):
    return t.detach().view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                            8: torch.int64}[t.element_size()])


def _assert_same_state(a, b):
    ta, tb = _held(a), _held(b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(_bits(x), _bits(y))
    assert a.state.loss_count == b.state.loss_count


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_round_trip_is_bit_exact_and_in_place(route, tmp_path):
    batches = _batches(6)
    trainer = _trainer(route)
    trainer.train_steps(batches[:3])
    saved = [t.detach().clone() for t in _held(trainer)]
    count = trainer.state.loss_count
    path = save_checkpoint(str(tmp_path / "ckpt_3.pt"), trainer.pipeline.sequential,
                           trainer.state)
    assert not os.path.exists(path + ".tmp")
    trainer.train_steps(batches[3:])  # move everything on
    live = _held(trainer)
    ptrs = [t.data_ptr() for t in live]
    assert not all(torch.equal(_bits(a), _bits(b)) for a, b in zip(saved, live))
    restore_checkpoint(path, trainer.pipeline.sequential, trainer.state)
    after = _held(trainer)
    assert [t.data_ptr() for t in after] == ptrs
    for want, got in zip(saved, after):
        assert torch.equal(_bits(want), _bits(got))
    assert int(trainer.state.step) == 3 and trainer.state.loss_count == count


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_resumed_run_equals_one_straight_run(route, tmp_path):
    batches = _batches(7, seed=1)
    straight = _trainer(route)
    want = [float(x) for x in straight.train_steps(batches)]
    first = _trainer(route, checkpoint_dir=str(tmp_path))
    got = [float(x) for x in first.train_steps(batches[:4])]
    first.save_checkpoint()
    assert os.path.basename(latest_checkpoint(str(tmp_path))) == "ckpt_4.pt"
    resumed = _trainer(route, checkpoint_dir=str(tmp_path))  # auto-resume
    assert int(resumed.state.step) == 4
    got += [float(x) for x in resumed.train_steps(batches[4:])]
    assert got == want
    _assert_same_state(resumed, straight)


def test_fit_writes_a_checkpoint_each_epoch_and_resumes(tmp_path):
    batches = _batches(3)
    trainer = _trainer("ondevice", checkpoint_dir=str(tmp_path))
    trainer.fit(batches, max_epochs=2)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_3.pt", "ckpt_6.pt"]
    again = _trainer("ondevice", checkpoint_dir=str(tmp_path))
    assert int(again.state.step) == 6
    fresh = _trainer("ondevice", checkpoint_dir=str(tmp_path), resume=False)
    assert int(fresh.state.step) == 0


def test_latest_checkpoint_takes_the_largest_step(tmp_path):
    assert latest_checkpoint(str(tmp_path / "missing")) is None
    assert latest_checkpoint(str(tmp_path)) is None
    for name in ("ckpt_9.pt", "ckpt_10.pt", "ckpt_2.pt", "ckpt_99.pt.tmp", "ckpt_x.pt",
                 "other_500.pt", "ckpt_7.msgpack"):
        (tmp_path / name).write_bytes(b"")
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt_10.pt")


def test_load_from_wins_over_resume_and_a_missing_one_raises(tmp_path):
    batches = _batches(5)
    trainer = _trainer("presorted", checkpoint_dir=str(tmp_path))
    trainer.train_steps(batches[:2])
    early = trainer.save_checkpoint()
    trainer.train_steps(batches[2:])
    trainer.save_checkpoint()
    assert int(_trainer("presorted", checkpoint_dir=str(tmp_path)).state.step) == 5
    chosen = _trainer("presorted", checkpoint_dir=str(tmp_path), load_from=early)
    assert int(chosen.state.step) == 2
    with pytest.raises(FileNotFoundError, match="not found"):
        _trainer("presorted", load_from=str(tmp_path / "ckpt_404.pt"))


def test_pipeline_load_from_is_restored(tmp_path):
    trainer = _trainer("dense")
    trainer.train_steps(_batches(2))
    path = trainer.save_checkpoint(str(tmp_path / "c.pt"))
    sparse, presort, _ = ROUTES["dense"]
    other = _trainer("dense", load_from=None)
    other.pipeline.load_from = path
    restored = Trainer(other.pipeline, presort=presort, seed=3)
    restored.init_state()
    _assert_same_state(restored, trainer)


@pytest.mark.parametrize("saved,restored", [("presorted", "dense"), ("dense", "ondevice")])
def test_a_sparse_checkpoint_does_not_restore_onto_the_dense_route(saved, restored, tmp_path):
    trainer = _trainer(saved)
    trainer.train_steps(_batches(1))
    path = trainer.save_checkpoint(str(tmp_path / "c.pt"))
    with pytest.raises(ValueError, match="set_sparse_embeddings"):
        _trainer(restored, load_from=path)


def test_another_model_does_not_restore(tmp_path):
    trainer = _trainer("ondevice")
    path = trainer.save_checkpoint(str(tmp_path / "c.pt"))
    inputs = Inputs({
        "feat_inputs": ValueInput(tuple(f"dense_{j}" for j in range(3))),
        "emb_inputs": MultiIndicesEmbedding(8, FIELDS, tuple(f"cat_{i}" for i in range(4)),
                                            device="cpu")})
    pipe = (Pipeline(device="cpu").set_inputs(inputs).set_model("DeepFM", deep_layer_sizes=(32,))
            .set_sparse_embeddings(True))
    with pytest.raises(ValueError, match="does not fit"):
        Trainer(pipe, presort=False, load_from=path).init_state()


def test_checkpoint_holds_only_tensors_and_plain_values(tmp_path):
    trainer = _trainer("presorted")
    trainer.train_steps(_batches(2))
    path = trainer.save_checkpoint(str(tmp_path / "c.pt"))
    saved = torch.load(path, map_location="cpu", weights_only=True)
    assert saved["sparse"] is True and saved["step"] == 2 and saved["loss_count"] == 2
    assert set(saved["params"]) == {n for n, _ in trainer.pipeline.sequential.named_parameters()}
    assert set(saved["row_slots"]) == {"inputs.schema.emb_inputs.embedding"}
    assert np.isfinite(float(saved["loss_sum"]))


def _xdeepfm_trainer(route, **kw):
    sparse, presort, _ = ROUTES[route]
    inputs = Inputs({
        "feat_inputs": ValueInput(tuple(f"dense_{j}" for j in range(3))),
        "emb_inputs": MultiIndicesEmbedding(8, FIELDS, tuple(f"cat_{i}" for i in range(4)),
                                            device="cpu")})
    pipe = (Pipeline(device="cpu").set_inputs(inputs)
            .set_model("xDeepFM", cin_layer_sizes=(6, 4), deep_layer_sizes=(16,))
            .set_optimizer("Adam", lr=1e-2).set_sparse_embeddings(sparse))
    trainer = Trainer(pipe, presort=presort, seed=3, **kw)
    trainer.init_state()
    return trainer


def _stats(trainer):
    from torecsys_tpu_torch.train.state import batch_stats

    return batch_stats(trainer.pipeline.sequential)


@pytest.mark.parametrize("route", ["presorted", "ondevice", "dense"])
def test_xdeepfm_batch_stats_save_restore_and_resume(route, tmp_path):
    batches = _batches(7, seed=2)
    straight = _xdeepfm_trainer(route)
    want = [float(x) for x in straight.train_steps(batches)]
    first = _xdeepfm_trainer(route, checkpoint_dir=str(tmp_path))
    got = [float(x) for x in first.train_steps(batches[:4])]
    stats = {k: v.clone() for k, v in _stats(first).items()}
    assert sorted(stats) == [f"model.cin.bn_{k}.{n}" for k in (0, 1) for n in ("mean", "var")]
    assert not torch.equal(stats["model.cin.bn_0.var"], torch.ones(6))
    path = first.save_checkpoint()
    saved = torch.load(path, map_location="cpu", weights_only=True)
    assert set(saved["buffers"]) == set(stats)
    first.train_steps(batches[4:])
    live = _stats(first)
    ptrs = {k: v.data_ptr() for k, v in live.items()}
    restore_checkpoint(path, first.pipeline.sequential, first.state)
    for name, value in _stats(first).items():
        assert value.data_ptr() == ptrs[name]
        assert torch.equal(_bits(value), _bits(stats[name])), name
    resumed = _xdeepfm_trainer(route, checkpoint_dir=str(tmp_path))  # auto-resume
    assert int(resumed.state.step) == 4
    got += [float(x) for x in resumed.train_steps(batches[4:])]
    assert got == want
    _assert_same_state(resumed, straight)


def test_a_checkpoint_without_buffers_restores_deepfm_and_not_xdeepfm(tmp_path):
    """A checkpoint of the format before running statistics (no ``buffers``
    key) restores a model without them, and is refused by one with them."""
    trainer = _trainer("ondevice")
    trainer.train_steps(_batches(2))
    path = trainer.save_checkpoint(str(tmp_path / "c.pt"))
    saved = torch.load(path, map_location="cpu", weights_only=True)
    assert saved["buffers"] == {}
    del saved["buffers"]
    old = str(tmp_path / "old.pt")
    torch.save(saved, old)
    _assert_same_state(_trainer("ondevice", load_from=old), trainer)
    xdeepfm = _xdeepfm_trainer("ondevice")
    path = xdeepfm.save_checkpoint(str(tmp_path / "x.pt"))
    saved = torch.load(path, map_location="cpu", weights_only=True)
    del saved["buffers"]
    torch.save(saved, old)
    with pytest.raises(ValueError, match="running statistics"):
        _xdeepfm_trainer("ondevice", load_from=old)
