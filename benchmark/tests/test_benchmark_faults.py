"""A whole run on the CPU at a tiny size, past the harness's look for a card,
with the timed path broken underneath (``calibrate.FAULTS``): ``correct``
has to come out false, under each cell's own limits, for each fault the
cell can have. (One card, so no exchange between chips to leave out.)"""
import time

import pytest
import torch

import calibrate
import harness
import tiny


def run(cell_name):
    cell = tiny.cell(cell_name)
    cell["limits"] = harness.load_json("workloads", cell_name)["limits"]
    return harness.run_cell(cell_name, 2 ** 31 + 9, 0.5, False, torch.device("cpu"),
                            time.perf_counter(), cell=cell, cfg=tiny.config(cell["config"]),
                            mix=tiny.traffic(cell["traffic"]))


CASES = [("maestro22k.inpaint_longgap", None), ("maestro22k.inpaint_longgap", "altered"),
         ("maestro22k.inpaint_longgap", "half_rows"),
         ("musicnet44k.inpaint_longgap", None), ("musicnet44k.inpaint_longgap", "altered"),
         ("maestro22k.train_b4", None), ("maestro22k.train_b4", "state_kept"),
         ("maestro22k.train_b4", "ema_kept"),
         ("maestro22k.train_b4", "half_batch")]


@pytest.mark.parametrize("cell, fault", CASES)
def test_correct_only_without_a_fault(cell, fault):
    with calibrate.planted(fault):
        assert run(cell)["correct"] == (fault is None)
