"""The harness's run at a tiny size on the CPU, with the timed path broken
underneath: each fault that a training step can have on one card makes
``correct`` come out false (a step that leaves its state unchanged, half
of the batch left out with the mean taken over the rest, the loss altered
where it is produced, and the K-step dispatch's steps all reading its first
batch's rows)."""

from __future__ import annotations

import time

import pytest
import torch
from conftest import tiny

import run as runner


def _broken_step(monkeypatch, wrap):
    import torecsys_tpu_torch.train.trainer as trainer_module

    make = trainer_module.make_train_step

    def make_broken(*args, **kwargs):
        return wrap(make(*args, **kwargs))

    monkeypatch.setattr(trainer_module, "make_train_step", make_broken)


def plant_unchanged(monkeypatch):
    from torecsys_tpu_torch.ops import sparse

    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    monkeypatch.setattr(sparse._RowOptimizerBase, "update_sorted",
                        lambda self, table, slots, *a, **k: (table, slots))


def plant_half_batch(monkeypatch):
    def wrap(step):
        def half(state, batch):
            return step(state, {k: v[:v.shape[0] // 2] for k, v in batch.items()})
        return half

    _broken_step(monkeypatch, wrap)


def plant_altered_loss(monkeypatch):
    def wrap(step):
        def altered(state, batch):
            state, logs = step(state, batch)
            return state, dict(logs, loss=logs["loss"] + 0.01)
        return altered

    _broken_step(monkeypatch, wrap)


def plant_stale_rows(monkeypatch):
    from torecsys_tpu_torch.train import steps

    init = steps.TrainScan.__init__

    def stale(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self._batches = [self._batches[0]] * self.k

    monkeypatch.setattr(steps.TrainScan, "__init__", stale)


FAULTS = {"unchanged": plant_unchanged, "half_batch": plant_half_batch,
          "altered_loss": plant_altered_loss, "stale_rows": plant_stale_rows}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell_name", ["deepfm_criteo.train", "xdeepfm_criteo.train"])
def test_a_broken_step_is_not_correct(monkeypatch, cell_name, fault):
    FAULTS[fault](monkeypatch)
    result = runner.execute(tiny(cell_name), 7, 0.3, False, torch.device("cpu"), time.time())
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["check"].values())
