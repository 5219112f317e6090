"""Tiny stand-ins for the benchmark's files: the 22.05 kHz configuration at
3 octaves of 8 bins over 2048 samples, computed in float32, T=3, and
traffic that fits its windows; its dp role over 2 ranks of 2 rows. And a
copy of the benchmark's files to run a cell from, as a checkout runs one,
with tiny files written in. For CPU tests only."""
from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
from typing import Sequence

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

WORDS = ["exp.audio_len=2048", "network.cqt.num_octs=3", "network.cqt.bins_per_oct=8",
         "network.Ns=[8,8,8]", "network.num_dils=[1,2,1]", "network.attention_layers=[0,0,1,1]",
         "network.depth=3", "tester.T=3", "exp.batch=2", "exp.lr_rampup_it=2"]
DP_RANKS = 2        # the dp role's ranks at the tiny size, 2 rows each


def _load(kind, name):
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def config(name: str = "cqtdiff_plus_22k") -> dict:
    cfg = copy.deepcopy(_load("configs", name))
    cfg["compose"] = cfg["compose"] + WORDS
    n = cfg["network"]
    n.update(Ns=[8, 8, 8], num_dils=[1, 2, 1], attention_layers=[0, 0, 1, 1], depth=3)
    n["cqt"].update(num_octs=3, bins_per_oct=8)
    cfg["exp"]["audio_len"] = 2048
    s = cfg["serving"]
    s["compose"] = ["network.compute_dtype=float32"]
    s["stated"]["network"]["compute_dtype"] = "float32"
    s["stated"]["tester"]["T"] = 3
    t = cfg["training"]["stated"]
    t["exp"].update(audio_len=2048, batch=2, lr_rampup_it=2)
    if "training_dp4" in cfg:
        dp = cfg["training_dp4"]
        dp["compose"] = [w for w in dp["compose"] if not w.startswith(("exp.batch=", "exp.mesh.dp="))] \
            + [f"exp.batch={2 * DP_RANKS}", f"exp.mesh.dp={DP_RANKS}"]
        dp["stated"]["exp"].update(audio_len=2048, batch=2 * DP_RANKS, lr_rampup_it=2)
        dp["stated"]["exp"]["mesh"]["dp"] = DP_RANKS
    return cfg


def traffic(name: str) -> dict:
    mix = copy.deepcopy(_load("traffic", name))
    if mix["kind"] == "inpaint":
        mix.update(request_s=0.3, pool=2)
        centres = [[0.06, 0.08], [0.22, 0.24]]
        for g, c in zip(mix["gaps"], centres):
            g.update(ms=[5, 15], centre_s=c)
    return mix


def cell(name: str) -> dict:
    c = _load("workloads", name)
    if c["chips"] > 1:
        c["chips"] = DP_RANKS
    return c


def tree(root: str, cells: Sequence[str] = ()) -> str:
    """A copy of the benchmark's files under ``root`` with the tiny
    stand-ins of ``cells`` (their cell, configuration and traffic files)
    written over the copies; returns its harness folder."""
    bench = os.path.join(root, "benchmark")
    shutil.copytree(HERE, bench, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    for name in cells:
        c = cell(name)
        write(bench, "workloads", name, c)
        write(bench, "configs", c["config"], config(c["config"]))
        write(bench, "traffic", c["traffic"], traffic(c["traffic"]))
    return bench


def write(bench: str, kind: str, name: str, obj: dict) -> None:
    with open(os.path.join(bench, kind, f"{name}.json"), "w") as f:
        json.dump(obj, f)


def command(bench: str, workload: str, seed: int, seconds: float, trace: int = 0,
            path: str = "program") -> list:
    """A run of ``workload`` from the copy ``bench`` on the CPU, with the
    program, the control or a planted fault (``calibrate.py --one``)."""
    return [sys.executable, os.path.join(bench, "calibrate.py"), "--one", path, "--device", "cpu",
            "--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)]


def env() -> dict:
    """The environment of such a run: the port from the repository, the
    test modules importable, few threads."""
    return {**os.environ, "PYTHONPATH": os.pathsep.join([ROOT, os.path.join(HERE, "tests")]),
            "OMP_NUM_THREADS": "2", "USE_FLAX": "0", "CUDA_VISIBLE_DEVICES": ""}


def run(cmd: list, timeout: float = 600) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env(), cwd=ROOT)


def result(out: subprocess.CompletedProcess) -> dict:
    """The result's line of a run that exited 0."""
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])
