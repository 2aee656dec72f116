"""The control of each cell's check, on a card at the cell's own size: the
reference put in the program's place and computed in TF32, the precision
below the configurations' float32 with TF32 off, has to fail one of the
cell's numbers on every seed, while the program passes them all. The
benchmark's runs do not run this; ``python -m yardstick.control`` gives the
readings the limits were set from."""

import math

import pytest

from yardstick import judge
from yardstick import spec as specs
from yardstick.tests.conftest import CELLS

SEEDS = (5_000_000_001, 5_000_000_002, 5_000_000_003)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_yardstick_control_fails_and_program_passes(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the control's arithmetic (TF32) exists only on a card")
    from yardstick import control

    cell = specs.load_cell(name)
    device = torch.device("cuda", 0)
    for row in control.control_readings(cell, SEEDS, device):
        assert not judge.verdict(row, cell.limits), row
    if cell.chips > torch.cuda.device_count():
        pytest.skip(f"the program side needs {cell.chips} cards")
    rows = (control.ranked_program_readings(cell, SEEDS[:1]) if cell.chips > 1
            else control.program_readings(cell, SEEDS[:1], device))
    for row in rows:
        assert judge.verdict(row, cell.limits), row
        assert all(math.isfinite(row[k]) for k in cell.limits)
