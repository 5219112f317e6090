"""On the card, at each cell's own size: the control (the configuration's
lower-precision path in the program's place: int8 convs for the bf16
serving cells, bf16 for the float32 training cell) comes out not correct
on three seeds, and the program comes out correct on them. Runs on the
card only: ``python -m pytest benchmark/tests -m card``."""
import pytest

import calibrate

CELLS = ["maestro22k.inpaint_longgap", "musicnet44k.inpaint_longgap", "maestro22k.train_b4"]
SEEDS = [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell, card):
    for r in calibrate.readings(cell, SEEDS, SEEDS, card):
        assert r["correct"] == (r["path"] == "program"), r
