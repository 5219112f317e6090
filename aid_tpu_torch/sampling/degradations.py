"""Degradation operators for posterior sampling (port of
``aid_tpu/sampling/degradations.py``): time-domain masks, STFT masks,
lowpass filters and decimation for bandwidth extension, hard clipping, the
STFT magnitude for phase retrieval and compressive-sensing masks. Each
constructor returns a differentiable closure x -> y (guidance backpropagates
through it).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import scipy.fft
import scipy.signal
import torch
import torch.nn.functional as F

from aid_tpu_torch.ops import stft as stft_ops


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


# --------------------------------------------------------------- STFT masking

def spectral_mask(mask_FT: torch.Tensor, stft_cfg) -> Callable:
    """Multiply the STFT by a (F, frames) mask and resynthesise. The signal
    is zero-padded by ``n_fft - T % n_fft`` first, as in the reference."""
    n_fft, hop, win = int(stft_cfg.n_fft), int(stft_cfg.hop_length), int(stft_cfg.win_length)

    def apply(x):
        T = x.shape[-1]
        xp = F.pad(x, (0, n_fft - T % n_fft))
        X = stft_ops.stft(xp, n_fft, hop, win)
        y = stft_ops.istft(X * mask_FT, n_fft, hop, win, length=xp.shape[-1])
        return y[..., :T]

    return apply


def spectral_projector(y: torch.Tensor, apply_mask: Callable) -> Callable:
    """Replacement projection for a linear degradation A: y + x - A(x)."""
    return lambda x: y + x - apply_mask(x)


def stft_magnitude(stft_cfg) -> Callable:
    """Phase-retrieval degradation |STFT(x)|."""
    n_fft, hop, win = int(stft_cfg.n_fft), int(stft_cfg.hop_length), int(stft_cfg.win_length)
    return lambda x: stft_ops.stft(x, n_fft, hop, win).abs()


# ------------------------------------------------------------------ lowpass

def firwin_lowpass(order: int, fc: float, fs: float, beta: float = 6.76) -> Callable:
    """FIR lowpass: ``scipy.signal.firwin`` taps (Kaiser window) as a
    same-length cross-correlation, padded (taps // 2, taps - 1 - taps // 2)."""
    taps = scipy.signal.firwin(numtaps=order + 1, cutoff=fc, fs=fs,
                               window=("kaiser", beta)).astype(np.float32)
    w = torch.from_numpy(taps)[None, None]
    pad = len(taps) // 2
    on_device: Dict[Tuple[torch.device, torch.dtype], torch.Tensor] = {}

    def apply(x):
        key = (x.device, x.dtype)
        if key not in on_device:        # copied once: a capture cannot copy from the host
            on_device[key] = w.to(x.device, x.dtype)
        z = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, len(taps) - 1 - pad))
        return F.conv1d(z, on_device[key]).reshape(x.shape)

    return apply


def iir_lowpass(kind: str, order: int, fc: float, fs: float,
                ripple: float = 0.05) -> Callable:
    """IIR lowpass (``cheby1``, else Butterworth) as the exact causal
    convolution with the filter's impulse response truncated to the signal
    length L: the recursion's first L outputs, computed by one FFT product
    at length >= 2L - 1 instead of L sequential steps (the filter sits in
    the guided score, which backpropagates through it every call).

    The impulse response is computed once per (length, device, dtype) on
    the host in f64 from scipy's f64 coefficients, and its spectrum kept on
    the device (a CUDA graph capture meets only filled entries: its warm-up
    ran the same call). (The JAX package runs the recursion with
    coefficients rounded to f32; from order 8 up that rounding moves the
    cheby1 response itself.) A filter with a pole on or outside the unit
    circle raises: its recursion diverges."""
    if kind == "cheby1":
        b, a = scipy.signal.cheby1(order, ripple, fc, fs=fs, btype="low")
    else:
        b, a = scipy.signal.butter(order, fc, fs=fs, btype="low")
    radius = float(np.abs(np.roots(a)).max()) if len(a) > 1 else 0.0
    if not radius < 1.0:
        raise ValueError(f"{kind} lowpass of order {order} at {fc} Hz (fs {fs} Hz) is "
                         f"unstable: its largest pole radius is {radius:.3g} >= 1")
    spectra: Dict[Tuple[int, torch.device, torch.dtype], Tuple[torch.Tensor, int]] = {}

    def apply(x):
        L = x.shape[-1]
        key = (L, x.device, x.dtype)
        if key not in spectra:
            impulse = np.zeros(L)
            impulse[0] = 1.0
            h = scipy.signal.lfilter(b, a, impulse).astype(np.float32)
            n = scipy.fft.next_fast_len(2 * L - 1, real=True)
            spectra[key] = (torch.fft.rfft(torch.from_numpy(h).to(x.device), n=n), n)
        H, n = spectra[key]
        return torch.fft.irfft(torch.fft.rfft(x, n=n) * H, n=n)[..., :L].to(x.dtype)

    return apply


def decimate(factor: int) -> Tuple[Callable, Callable]:
    """Subsample / zero-stuff pair for decimation BWE."""
    def down(x):
        return x[..., ::factor]

    def up(x):
        z = torch.zeros(*x.shape, factor - 1, dtype=x.dtype, device=x.device)
        return torch.cat([x[..., None], z], dim=-1).reshape(*x.shape[:-1], -1)

    return down, up


def bwe_lowpass(filter_type: str, order: int, fc: float, fs: float) -> Callable:
    """The bandwidth-extension degradation for ``tester.bandwidth_extension
    .filter.type``: firwin, cheby1, biquad/butter (second-order
    Butterworth), or decimate/resample (subsample by round(fs / 2 fc), then
    zero-stuff back). The sampler guides with it and the tester builds the
    observation with it."""
    if filter_type == "firwin":
        return firwin_lowpass(order, fc, fs)
    if filter_type in ("cheby1", "biquad", "butter"):
        return iir_lowpass("cheby1" if filter_type == "cheby1" else "butter",
                           order if filter_type == "cheby1" else 2, fc, fs)
    if filter_type in ("decimate", "resample"):
        down, up = decimate(int(round(fs / (2 * fc))))
        return lambda x: up(down(x))
    raise ValueError(f"unknown BWE filter {filter_type!r}")


# ------------------------------------------------------------------ clipping

def hard_clip(clip_value) -> Callable:
    """Declipping degradation: clip to [-clip_value, clip_value] (a number
    or a 0-dim tensor, which a program holds as its buffer)."""
    return lambda x: torch.clamp(x, -clip_value, clip_value)


def clip_value_from_sdr(x: torch.Tensor, sdr_db: float) -> torch.Tensor:
    """The clip level giving the requested SDR over all of x: 40 bisection
    steps in f32 on x's device, between 1e-4 and max |x|."""
    energy = x.square().sum()

    def sdr_of(cv):
        err = x - torch.clamp(x, -cv, cv)
        return 10.0 * torch.log10(energy / (err.square().sum() + 1e-12))

    lo = torch.tensor(1e-4, dtype=x.dtype, device=x.device)
    hi = x.abs().max()
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        too_high = sdr_of(mid) > sdr_db
        lo, hi = torch.where(too_high, lo, mid), torch.where(too_high, mid, hi)
    return 0.5 * (lo + hi)


# --------------------------------------------------------------- comp. sensing

def compsens_mask(shape, percentage: float, generator: Optional[torch.Generator] = None,
                  device=None) -> torch.Tensor:
    """Random sample mask keeping ``percentage``% of the samples."""
    u = torch.rand(shape, generator=generator, device=device)
    return (u < percentage / 100.0).float()
