"""On the card, at each cell's own size: the control (the configuration's
lower-precision path in the program's place: int8 convs for the bf16
serving cells, bf16 for the float32 training cells) comes out not correct
on three seeds, and the program comes out correct on them. Runs on the
card only, a cell over several cards only where there are as many:
``python -m pytest benchmark/tests -m card``."""
import pytest
import torch

import calibrate
import harness

CELLS = ["maestro22k.inpaint_longgap", "musicnet44k.inpaint_longgap", "maestro22k.train_b4",
         "maestro22k.train_dp4"]
SEEDS = [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell, card):
    chips = harness.load_json("workloads", cell)["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA cards")
    for r in calibrate.readings(cell, SEEDS, SEEDS, card):
        assert r["correct"] == (r["path"] == "program"), r
