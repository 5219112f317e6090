"""The work of one DiffWave forward (``"architecture": "diffwave"``), counted
from the configuration's shapes at batch 1: the multiply-adds by kind, no
fused norm x adaLN x GELU launch, and the bytes of its gate launches.

A forward at C channels over L samples: the input 1x1 conv (C L), in each
of the ``residual_layers`` layers a dilated k=3 conv C -> 2C (6 C^2 L) and
a 1x1 conv C -> 2C (2 C^2 L), the skip 1x1 conv (C^2 L) and the output
1x1 conv (C L); a row's step embedding (E H + H^2) and each layer's
projection of it (H C). At the published sizes 18.94 M multiply-adds a
sample, 4.965 TFLOP a forward of a 131072-sample row.

The gate, sigmoid(z[:, :C]) tanh(z[:, C:]), reads z [rows, 2C, L] and
writes g [rows, C, L] once a launch (3 rows C L elements); its backward
reads z and dg and writes dz (5 rows C L elements); one launch each way a
layer.
"""
from __future__ import annotations

from typing import Dict, List, Tuple


def _sizes(cfg: dict):
    n = cfg["network"]
    return (int(n["residual_channels"]), int(n["residual_layers"]), int(n["emb_dim"]),
            int(n["emb_hidden"]), int(cfg["exp"]["audio_len"]))


def forward_macs(cfg: dict) -> Dict[str, int]:
    C, n, E, H, L = _sizes(cfg)
    return {"conv": n * 3 * C * 2 * C * L,
            "conv1x1": (C + n * C * 2 * C + C * C + C) * L,
            "dense": E * H + H * H + n * H * C}


def fused_launches(cfg: dict) -> List[Tuple[int, int]]:
    return []


def gate_bytes(cfg: dict, rows: int, itemsize: int) -> Tuple[int, int]:
    """(forward, backward) bytes of one forward's gate launches at ``rows``
    rows in a dtype of ``itemsize`` bytes: z read and g written once; z and
    dg read and dz written once."""
    C, n, _, _, L = _sizes(cfg)
    elems = rows * C * L * itemsize
    return n * 3 * elems, n * 5 * elems

