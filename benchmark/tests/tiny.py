"""Tiny stand-ins for the benchmark's files: the 22.05 kHz configuration at
3 octaves of 8 bins over 2048 samples, computed in float32, T=3, and
traffic that fits its windows. For CPU tests only."""
from __future__ import annotations

import copy
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORDS = ["exp.audio_len=2048", "network.cqt.num_octs=3", "network.cqt.bins_per_oct=8",
         "network.Ns=[8,8,8]", "network.num_dils=[1,2,1]", "network.attention_layers=[0,0,1,1]",
         "network.depth=3", "tester.T=3", "exp.batch=2", "exp.lr_rampup_it=2"]


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
    return _load("workloads", name)
