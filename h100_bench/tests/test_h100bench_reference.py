"""The port against the plain reference over the compared steps (two K-step
dispatches) at a tiny size on the CPU, through the harness's own run, and
the result line's keys."""

from __future__ import annotations

import time

import pytest
import torch
from conftest import CELLS, tiny

import run as runner
from harness import check


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_sound_run_is_correct_and_its_line_has_the_contract_keys(cell_name):
    cell = tiny(cell_name)
    result = runner.execute(cell, 2**31 + 3, 0.5, False, torch.device("cpu"), time.time())
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(set(m) == {"value", "unit"} for m in result["metrics"].values())
    assert list(result["check"]) == list(check.NUMBERS)
    for c in result["check"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


@pytest.mark.parametrize("name", ["deepfm_criteo.train", "xdeepfm_criteo.train"])
def test_program_and_reference_readings_agree(name):
    cell = tiny(name)
    run = cell.model.make_run(cell, torch.device("cpu"), 11)
    run.setup(warm=False)
    run.free()
    reference = run.reference()
    assert len(run.readings["losses"]) == len(reference["losses"]) == 2 * run.k
    numbers = check.compare(run.readings, reference)
    assert numbers["loss_gap"] < 1e-6 and numbers["grad_gap"] < 1e-3
    for key in ("grad_norms", "change_norms"):
        assert set(run.readings[key]) == set(reference[key]) == set(reference["grad_norms"])
    assert all(v > 0 for v in reference["change_norms"].values())


def test_dropout_masks_are_torchs_from_the_seed():
    """The reference's dropout keeps what the program's ``nn.Dropout`` keeps
    after the same seed, and the masks differ from step to step."""
    from reference.ctr import Dropout

    x = torch.randn(64, 16).to(torch.bfloat16)
    layer = torch.nn.Dropout(0.5).train()
    torch.manual_seed(5)
    program = [layer(x) for _ in range(2)]
    drop = Dropout(0.5, torch.bfloat16)
    torch.manual_seed(5)
    ours = [drop(x.double()) for _ in range(2)]
    for p, r in zip(program, ours):
        assert torch.equal(p.double(), r)
    assert not torch.equal(program[0] != 0, program[1] != 0)
