"""A whole run on the CPU at a tiny size, past the harness's look for a card,
with the timed path broken underneath (``calibrate.FAULTS``): ``correct``
has to come out false, under each cell's own limits, for each fault the
cell can have. The cells on one card run in this process; the dp cell over
two ranks from a copy of the benchmark's files, the fault planted in every
rank, and it can have one more: its exchange between the ranks left out."""
import time

import pytest
import torch

import calibrate
import harness
import tiny

DP = "maestro22k.train_dp4"


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


@pytest.mark.parametrize("fault", ["exchange_left_out", "half_batch", "state_kept", "ema_kept"])
def test_the_dp_cell_is_not_correct_with_a_fault(tmp_path, fault):
    bench = tiny.tree(str(tmp_path), [DP])
    line = tiny.result(tiny.run(tiny.command(bench, DP, 2 ** 31 + 9, 0.5, path=fault)))
    assert not line["correct"], line["checks"]
    assert line["checks"]["ranks_out_of_step"]["value"] == 0
