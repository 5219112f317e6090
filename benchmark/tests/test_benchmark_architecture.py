"""The architecture a configuration file states is found by name: the CQT
U-Net's counts and parameters are what they were before they moved to
``reference/cqtdiff_plus.py`` and ``work/cqtdiff_plus.py``, and a stub
architecture added as new files only (its configuration, reference, work,
traffic and cell; the program's net in the test module ``stub_net``) runs
a tiny inpainting cell through the harness with every reader."""
import filecmp
import hashlib
import json
import math
import os
import shutil

import pytest

import harness
import port
import tiny
from work import counts

# the counts and parameters of the two configurations before the move
BEFORE = {
    "cqtdiff_plus_22k": {
        "macs": {"dense": 8245682176, "conv1x1": 34605105152, "conv": 974279147520, "fir": 410517504,
                 "attention": 240123904},
        "launches": (90, "a1bccdd199b899935b865052352acc7352cb17d81f0eef7a9a3733c362a8742e"),
        "params": (660, 186279648, "97b126922c0da9394dab89a0cec32a08c5c9b936ff1ddaa762b365e51536db9b")},
    "cqtdiff_plus_44k": {
        "macs": {"dense": 11350745088, "conv1x1": 51931774976, "conv": 1527015014400, "fir": 729219072,
                 "attention": 285212672},
        "launches": (111, "f95de5bf0176a38797bb12ddfe590b4eba7b4b767843980c4486e14f8db7b1cc"),
        "params": (793, 242249120, "b7758625c2563037ce2a079902a51ff24ac44ecc5979aa5e9117af8722b3fa8c")},
}


def _sha(obj) -> str:
    return hashlib.sha256(json.dumps(obj).encode()).hexdigest()


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_the_cqt_unet_counts_and_parameters_are_unchanged(name):
    cfg = harness.load_json("configs", name)
    assert cfg["architecture"] == "cqtdiff_plus"
    before = BEFORE[name]
    assert counts.forward_macs(cfg) == before["macs"]
    launches = counts.fused_launches(cfg)
    assert (len(launches), _sha([list(x) for x in launches])) == before["launches"]
    shapes = port.architecture(cfg).param_shapes(cfg["network"])
    size = sum(math.prod(s) for _, s in shapes)
    assert (len(shapes), size, _sha([[n, list(s)] for n, s in shapes])) == before["params"]


STUB = os.path.join(harness.HERE, "tests", "stub")


def stub_config() -> dict:
    cfg = tiny.config()
    for role in ("training", "training_dp4"):
        cfg.pop(role)
    cfg.update(architecture="stub_wave", source="a stub for the benchmark's tests", reduced=[],
               network={"callable": "stub_net.build", "channels": 8})
    cfg["compose"] = cfg["compose"] + ["network.callable=stub_net.build", "network.channels=8"]
    cfg["serving"]["rows_per_round"] = 2
    return cfg


def test_a_new_architecture_needs_new_files_only(tmp_path):
    bench = tiny.tree(str(tmp_path))
    added = {"configs/stub_wave.json", "traffic/stub_gaps.json", "workloads/stub_wave.inpaint.json",
             "reference/stub_wave.py", "work/stub_wave.py"}
    for sub in ("reference", "work"):
        shutil.copy(os.path.join(STUB, sub, "stub_wave.py"), os.path.join(bench, sub))
    tiny.write(bench, "configs", "stub_wave", stub_config())
    tiny.write(bench, "traffic", "stub_gaps", tiny.traffic("longgap_20s_2gaps"))
    tiny.write(bench, "workloads", "stub_wave.inpaint",
               {"config": "stub_wave", "traffic": "stub_gaps", "chips": 1,
                "limits": {"gap_rel_err": 1e-4}})
    # nothing that was there changed: the copy's other files are the benchmark's
    for d, _, files in os.walk(bench):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), bench)
            if rel not in added and "__pycache__" not in rel:
                assert filecmp.cmp(os.path.join(d, f), os.path.join(harness.HERE, rel), shallow=False), rel
    line = tiny.result(tiny.run(tiny.command(bench, "stub_wave.inpaint", 2 ** 31 + 21, 0.5, trace=1)))
    assert line["correct"], line["checks"]
    assert line["checks"]["gap_rel_err"]["value"] <= 1e-4
    # every reader ran; the program's spans are there to read on the CPU
    assert "host_ms_per_request.sample" in line["metrics"]
    assert "fused_adaln_roofline.sample" not in line["metrics"]     # no fused launches
