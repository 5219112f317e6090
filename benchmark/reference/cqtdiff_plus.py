"""The CQTDiff+ octave-CQT U-Net as the harness finds an architecture by the
name a configuration file states (``"architecture": "cqtdiff_plus"``): the
parameters' names and shapes, and the plain float32 net with its output
filter, the CQT's DC and Nyquist band limit that the sampler applies to
its estimate. ``unet.py`` and ``cqt.py`` are its implementation. Imports
nothing of the port.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from reference.cqt import CQT
from reference.unet import UNet, param_shapes  # noqa: F401  (the architecture's param_shapes)


def build(cfg: dict, device) -> Tuple[torch.nn.Module, Optional[Callable]]:
    """(the U-Net on ``device`` with uninitialised weights, its output filter)."""
    n, e = cfg["network"], cfg["exp"]
    cqt = CQT(int(n["cqt"]["num_octs"]), int(n["cqt"]["bins_per_oct"]), float(e["sample_rate"]),
              int(e["audio_len"]), ("kaiser", float(n["cqt"]["beta"])))
    with torch.device(device):
        net = UNet(n, cqt)
    return net, cqt.apply_hpf_DC
