"""Inpainting degradation operators (port of the masking part of
``aid_tpu/sampling/degradations.py``)."""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def time_mask(mask: torch.Tensor) -> Callable:
    """Inpainting degradation: pointwise mask multiply."""
    return lambda x: mask * x


def _smooth_row(m: np.ndarray, hann_size: int) -> np.ndarray:
    n = len(m)
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(2 * hann_size) / (2 * hann_size))
    out = m.astype(np.float64).copy()
    for i in np.flatnonzero(np.diff(m) != 0) + 1:
        if m[i] == 0:      # entering a gap: fade out before it
            lo = max(0, i - hann_size)
            out[lo:i] = hann[hann_size:][hann_size - (i - lo):]
        else:              # leaving a gap: fade in after it
            hi = min(n, i + hann_size)
            out[i:hi] = hann[: hi - i]
    return out.astype(np.float32)


def make_smooth_mask(mask: np.ndarray, hann_size: int) -> np.ndarray:
    """Hann cross-fades on the observed side of each gap edge: the gap stays
    zero; the ``hann_size`` observed samples before a 1->0 edge ramp down and
    after a 0->1 edge ramp up. A batched mask [B, L] is smoothed row by row
    (the JAX package smooths row 0 and broadcasts it, a known fault)."""
    mask = np.asarray(mask)
    if mask.ndim == 2:
        return np.stack([_smooth_row(m, hann_size) for m in mask])
    return _smooth_row(mask, hann_size)


def inpainting_projector(y_masked: torch.Tensor, smooth_mask: torch.Tensor) -> Callable:
    """Data-consistency projection m*y + (1-m)*x."""
    return lambda x: smooth_mask * y_masked + (1.0 - smooth_mask) * x
