"""The ``diffwave`` architecture, added as new files only: its reference's
parameters are the program's, its work counts are the hand formula's, and
a tiny DiffWave inpainting cell runs through ``harness.run_cell`` on the
CPU against the reference."""
import copy
import math

import pytest
import torch

import harness
import port
from reference import diffwave as ref_dw
from work import counts
from work import diffwave as work_dw

CPU = torch.device("cpu")
CELL = "libri16k.inpaint_longgap"
TINY = {"residual_channels": 8, "residual_layers": 6, "dilation_cycle_length": 3, "emb_dim": 16,
        "emb_hidden": 32}


def tiny_config() -> dict:
    """The cell's configuration at C=8, 6 layers, 2048 samples, f32, T=3."""
    cfg = copy.deepcopy(harness.load_json("configs", "diffwave_16k"))
    cfg["network"].update(TINY)
    cfg["exp"]["audio_len"] = 2048
    cfg["compose"] = cfg["compose"] + [f"network.{k}={v}" for k, v in TINY.items()] \
        + ["exp.audio_len=2048", "tester.T=3"]
    s = cfg["serving"]
    s["compose"] = ["network.compute_dtype=float32"]
    s["stated"]["network"]["compute_dtype"] = "float32"
    s["stated"]["tester"]["T"] = 3
    return cfg


def tiny_traffic() -> dict:
    mix = copy.deepcopy(harness.load_json("traffic", "speech_20s_2gaps"))
    mix.update(request_s=0.45, pool=2)
    for g, c in zip(mix["gaps"], ([0.06, 0.07], [0.33, 0.34])):
        g.update(ms=[5, 15], centre_s=c)
    return mix


def test_reference_parameters_are_the_programs():
    cfg = tiny_config()
    net = port.network(port.compose(cfg, "serving"), cfg, 1, CPU, trainable=False)
    assert ref_dw.param_shapes(cfg["network"]) == sorted(
        (n, tuple(p.shape)) for n, p in net.state_dict().items())
    published = harness.load_json("configs", "diffwave_16k")
    assert sum(math.prod(s) for _, s in ref_dw.param_shapes(published["network"])) == 24_034_305


def test_work_is_the_hand_formula():
    cfg = harness.load_json("configs", "diffwave_16k")
    C, n, L = 256, 36, 131072
    macs = counts.forward_macs(cfg)
    assert macs == {"conv": n * 6 * C * C * L, "conv1x1": (2 * C + n * 2 * C * C + C * C) * L,
                    "dense": 128 * 512 + 512 * 512 + n * 512 * C}
    assert round(sum(macs.values()) / L / 1e6, 2) == 18.94
    assert round(counts.forward_flops(cfg, 1) / 1e12, 3) == 4.965
    assert counts.fused_launches(cfg) == [] and counts.fused_bytes(cfg, 2, 2) == 0
    fwd, bwd = work_dw.gate_bytes(cfg, 2, 2)
    assert (round(fwd / 1e9, 1), round(bwd / 1e9, 1)) == (14.5, 24.2)


def test_the_harness_refuses_other_sizes():
    bad = tiny_config()
    bad["network"]["residual_layers"] = 5
    with pytest.raises(ValueError, match="residual_layers"):
        port.compose(bad, "serving")


def test_a_tiny_diffwave_cell_runs_through_the_harness():
    """One request of two gaps, one 2-row round, in f32 on the CPU: every
    observed sample back and the gaps at the reference's within f32 sums."""
    cell = copy.deepcopy(harness.load_json("workloads", CELL))
    cell["limits"]["gap_rel_err"] = 1e-4
    line = harness.run_cell(CELL, 2 ** 31 + 29, 0.0, False, CPU, 0.0, cell=cell,
                            cfg=tiny_config(), mix=tiny_traffic())
    assert line["correct"], line["checks"]
    assert line["checks"]["observed_changed"]["value"] == 0
    assert line["metrics"]["rtf"]["value"] > 0


@pytest.mark.card
def test_control_fails_and_program_passes_on_the_card(card):
    """At the cell's own size: the fp8 control not correct, the bf16 program
    correct, on three seeds (as ``test_benchmark_control.py`` holds the
    other cells)."""
    import calibrate
    seeds = [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303]
    for r in calibrate.readings(CELL, seeds, seeds, card):
        assert r["correct"] == (r["path"] == "program"), r
