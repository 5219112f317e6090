"""The work a denoiser forward needs, counted from the configuration's shapes.

The architecture a configuration file states (``"architecture"``) is found
by name: ``work/<architecture>.py`` gives ``forward_macs(cfg)``, the
multiply-adds of one forward at batch 1 by kind, and
``fused_launches(cfg)``, the (R, C) of each launch of the fused norm x
adaLN x GELU function in one forward ([] where the architecture has none).

Model FLOPs are 2 x those multiply-adds. A guided score is a forward plus
the input-gradient backward, counted as a second forward's FLOPs; an
unguided score is one forward; a training step is a forward and a backward,
3 forwards; rematerialised recomputation is not counted.

The fused function's bytes are one read of x and one write of y in the
compute dtype plus its two [B, C] float32 tables (the arithmetic of
``chip_smoke.py``'s ``time_kernel``: 2.076 GB a 22.05 kHz bf16 call at one
row).
"""
from __future__ import annotations

import importlib
import os
import sys
from typing import Dict, List, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _architecture(cfg: dict):
    return importlib.import_module("work." + cfg["architecture"])


def forward_macs(cfg: dict) -> Dict[str, int]:
    """Multiply-adds of one forward at batch 1, by kind."""
    return _architecture(cfg).forward_macs(cfg)


def forward_flops(cfg: dict, rows: int) -> float:
    """Model FLOPs of one denoiser forward at ``rows`` rows."""
    return 2.0 * rows * sum(forward_macs(cfg).values())


def score_flops(cfg: dict, rows: int, guided: bool) -> float:
    return (2.0 if guided else 1.0) * forward_flops(cfg, rows)


def step_flops(cfg: dict, rows: int) -> float:
    return 3.0 * forward_flops(cfg, rows)


def fused_launches(cfg: dict) -> List[Tuple[int, int]]:
    """(R, C) of every fused launch of one forward, R = F T rows of C."""
    return list(_architecture(cfg).fused_launches(cfg))


def fused_bytes(cfg: dict, rows: int, itemsize: int) -> int:
    """Bytes the fused launches of one forward need at ``rows`` rows: x read
    and y written once in the compute dtype, two [B, C] float32 tables."""
    return sum(2 * rows * R * C * itemsize + 2 * rows * C * 4 for R, C in fused_launches(cfg))
