"""The plain reference against the program's plain path on the CPU at a tiny
size, in float32: the U-Net forward, and each kind's whole run (set-up,
units, the comparison that decides ``correct``)."""
import numpy as np
import pytest
import torch

import calibrate
import inputs
import port
import tiny

CPU = torch.device("cpu")


def test_reference_unet_matches_the_program():
    cfg = tiny.config()
    args = port.compose(cfg, "serving")
    prog = port.network(args, cfg, 7, CPU, trainable=False)
    ref, _ = port.reference_net(cfg, 7, CPU)
    x = torch.from_numpy(np.stack([inputs.music(2048, 22050, s) for s in (1, 2)]))
    cn = torch.tensor([[0.25 * np.log(0.3)], [0.25 * np.log(0.02)]], dtype=torch.float32)
    with torch.no_grad():
        a, b = prog(x, cn), ref(x, cn)
    assert torch.linalg.vector_norm(a - b) <= 1e-5 * torch.linalg.vector_norm(b)


# float32 against float32: what remains is the order of sums
AGREE = {"gap_rel_err": 1e-4, "observed_changed": 0, "loss_rel_err": 1e-5, "grad_leaf_gap": 1e-4,
         "change_median_gap": 1e-3, "ema_leaf_gap": 1e-3}


@pytest.mark.parametrize("cell", ["maestro22k.inpaint_longgap", "maestro22k.train_b4"])
def test_each_kind_agrees_with_the_reference(cell):
    c = tiny.cell(cell)
    (r,) = calibrate.readings(cell, [2 ** 31 + 3], [], CPU, cell=c, cfg=tiny.config(c["config"]),
                              mix=tiny.traffic(c["traffic"]))
    assert "error" not in r, r
    for name, value in r["numbers"].items():
        assert value <= AGREE[name], (name, value)


def test_44k_inpainting_agrees_with_the_reference():
    c = tiny.cell("musicnet44k.inpaint_longgap")
    cfg = tiny.config(c["config"])
    mix = tiny.traffic(c["traffic"])
    mix["request_s"] = 0.15
    mix["gaps"][0].update(centre_s=[0.07, 0.08])
    (r,) = calibrate.readings("x", [11], [], CPU, cell=c, cfg=cfg, mix=mix)
    assert r["numbers"]["observed_changed"] == 0
    assert r["numbers"]["gap_rel_err"] <= AGREE["gap_rel_err"]
