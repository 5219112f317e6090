"""STFT and its least-squares inverse (port of ``aid_tpu/ops/stft.py``).

Conventions: centre reflect padding, one-sided spectrum ``[..., F, frames]``,
periodic Hann window, inverse by windowed overlap-add divided by the summed
squared window (floored at 1e-11, as the JAX package). Both directions are
differentiable: spectral guidance backpropagates through them.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann (``torch.hann_window``'s default), made once per
    (length, dtype, device) and kept there: a copy from the host on every
    call would wait for the host, and a CUDA graph capture cannot copy from
    pageable memory. The tensor is shared: callers must not write to it."""
    return _hann(int(win_length), dtype, torch.device("cpu" if device is None else device))


@functools.lru_cache(maxsize=None)
def _hann(win_length: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    n = np.arange(win_length)
    return torch.as_tensor(0.5 - 0.5 * np.cos(2 * np.pi * n / win_length), dtype=dtype,
                           device=device)


def _window(window: Optional[torch.Tensor], n_fft: int, win_length: int,
            device) -> torch.Tensor:
    if window is None:
        window = hann_window(win_length, device=device)
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        window = F.pad(window, (pad, n_fft - win_length - pad))
    return window


def stft(x: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
         window: Optional[torch.Tensor] = None, center: bool = True) -> torch.Tensor:
    """x [..., T] -> complex [..., F = n_fft // 2 + 1, frames]."""
    window = _window(window, n_fft, win_length, x.device)
    if center:
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (n_fft // 2, n_fft // 2), mode="reflect")
        x = x.reshape(*lead, x.shape[-1])
    frames = x.unfold(-1, n_fft, hop_length) * window       # [..., frames, n_fft]
    return torch.fft.rfft(frames, dim=-1).transpose(-1, -2)


def istft(spec: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
          window: Optional[torch.Tensor] = None, length: Optional[int] = None,
          center: bool = True) -> torch.Tensor:
    """Least-squares inverse: overlap-add of the windowed frames divided by
    the overlap-added squared window."""
    window = _window(window, n_fft, win_length, spec.device)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * window
    lead, n_frames = frames.shape[:-2], frames.shape[-2]
    total = n_fft + hop_length * (n_frames - 1)

    def overlap_add(f):                     # [N, frames, n_fft] -> [N, total]
        return F.fold(f.transpose(1, 2), output_size=(1, total), kernel_size=(1, n_fft),
                      stride=(1, hop_length)).reshape(f.shape[0], total)

    y = overlap_add(frames.reshape(-1, n_frames, n_fft)).reshape(*lead, total)
    wsq = overlap_add((window ** 2).expand(1, n_frames, n_fft))[0]
    y = y / torch.clamp_min(wsq, 1e-11)
    if center:
        y = y[..., n_fft // 2: total - n_fft // 2]
    if length is not None:
        y = y[..., :length]
    return y


def spectrogram_db(x: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
                   win_length: int = 1024, floor_db: float = -80.0) -> torch.Tensor:
    """Magnitude spectrogram in dB below its peak, floored (for logging)."""
    db = 20.0 * torch.log10(torch.clamp_min(stft(x, n_fft, hop_length, win_length).abs(),
                                            1e-8))
    return torch.clamp_min(db - db.max(), floor_db)
