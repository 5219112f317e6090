"""The work of one forward of the benchmark tests' stub architecture
(``stub_wave``): its convolutions' and its embedding's multiply-adds at
batch 1; it has no fused launch."""
from __future__ import annotations

from typing import Dict, List, Tuple


def forward_macs(cfg: dict) -> Dict[str, int]:
    C, L = int(cfg["network"]["channels"]), int(cfg["exp"]["audio_len"])
    return {"conv": 3 * C * L, "conv1x1": C * L, "dense": C}


def fused_launches(cfg: dict) -> List[Tuple[int, int]]:
    return []
