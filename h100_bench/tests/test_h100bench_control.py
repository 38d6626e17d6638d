"""On the card (marked ``h100``): at the cell's own size, the control (the
reference one precision step below the configuration's, in the program's
place) fails the cell's limits, and the program passes them, on one seed.
``calibrate.py`` takes the same readings over a dozen seeds."""

from __future__ import annotations

import pytest
from conftest import CELLS, ROOT

from harness import cell as cells
from harness import check


@pytest.mark.h100
@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_fails_and_the_program_passes(card, cell_name):
    cell = cells.load(cell_name, ROOT)
    run = cell.model.make_run(cell, card, 2**31 + 101)
    run.setup(warm=False)
    run.free()
    reference = run.reference("stated")
    assert check.judge(check.compare(run.readings, reference), cell.limits)
    assert not check.judge(check.compare(run.reference("control"), reference), cell.limits)
