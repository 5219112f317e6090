"""Training utilities: rational-rate resampling, A-weighting, EMA schedules,
batch augmentation.

Port of ``aid_tpu/training/utils.py``. Filters are designed on the host
(numpy / scipy) and applied on the batch's device.

Resampling is the JAX package's ``conv_general_dilated`` (input dilated by
``up``, stride ``down``, padding ``k // 2`` on both sides, the Kaiser-sinc
filter of ``_design_polyphase``) computed in polyphase form, the same
function without the dilated buffer: 48000 -> 22050 is 147:320 with a
7681-tap filter, and the dilated input would hold 405000 * 147 = 59.5 M
samples per row. Output ``n = q up + r`` is

    y[q up + r] = sum_u x[q down + u] h[u up + pad - r down]

so each residue ``r`` is a ``down``-strided correlation with its own phase of
``h``. All ``up`` phases are laid side by side in one ``[L, up]`` matrix
(zero where a phase has no tap), and the output is one matrix product of
the ``down``-strided windows of x (an ``unfold`` view) with it.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import scipy.signal
import torch
import torch.nn.functional as F


# ------------------------------------------------------------------ resampling

@functools.lru_cache(maxsize=16)
def _design_polyphase(up: int, down: int, taps_per_phase: int = 24,
                      beta: float = 8.555) -> np.ndarray:
    """Kaiser-windowed sinc lowpass for rational resampling, length up*taps."""
    cutoff = 1.0 / max(up, down)
    half = taps_per_phase * max(up, down) // 2
    n = np.arange(-half, half + 1)
    h = cutoff * np.sinc(cutoff * n) * np.kaiser(len(n), beta) * up
    return h.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _phase_matrix(up: int, down: int):
    """(W [L, up], u_min): W[u - u_min, r] = h[u up + pad - r down] where that
    tap exists, else 0."""
    h = _design_polyphase(up, down)
    k = h.shape[0]
    pad = k // 2
    c = pad - down * np.arange(up)                      # tap offset of residue r
    u_min = -(pad // up)                                # r = 0 reaches furthest left
    u_max = (k - 1 - int(c.min())) // up
    u = np.arange(u_min, u_max + 1)
    j = u[:, None] * up + c[None, :]                    # [L, up] tap indices
    W = np.where((j >= 0) & (j < k), h[np.clip(j, 0, k - 1)], 0.0)
    return W.astype(np.float32), u_min


def resample(x: torch.Tensor, orig_fs: int, new_fs: int) -> torch.Tensor:
    """Rational-rate polyphase resampling along the last axis; output length
    ceil(T up / down), the last computed sample repeated where the strided
    conv falls short, as in the JAX package."""
    if orig_fs == new_fs:
        return x
    g = math.gcd(int(orig_fs), int(new_fs))
    up, down = int(new_fs) // g, int(orig_fs) // g
    W, u_min = _phase_matrix(up, down)
    L = W.shape[0]
    lead, T = x.shape[:-1], x.shape[-1]
    got = (T - 1) * up // down + 1                      # the strided conv's length
    out_len = -(-T * up // down)
    Q = -(-got // up)                                   # windows: one per up outputs
    right = (Q - 1) * down + L - (T - u_min)
    z = F.pad(x.reshape(-1, T), (-u_min, max(right, 0)))
    win = z.unfold(-1, L, down)[:, :Q]                  # [N, Q, L] strided view
    w = torch.from_numpy(W).to(x.device, x.dtype)
    y = torch.matmul(win, w).reshape(z.shape[0], Q * up)[:, :got]
    if got < out_len:
        y = torch.cat([y, y[:, -1:].expand(-1, out_len - got)], dim=-1)
    return y.reshape(lead + (out_len,))


def _fit(y: torch.Tensor, T_out: int) -> torch.Tensor:
    return y[..., :T_out] if y.shape[-1] >= T_out else F.pad(y, (0, T_out - y.shape[-1]))


def resample_batch(batch: torch.Tensor, fs_batch: Sequence[int],
                   target_fs: int) -> torch.Tensor:
    """Resample each row of ``batch`` [B, T] from its rate in ``fs_batch``
    (host ints, one per row) to ``target_fs``, cropped or zero-padded back to
    T. The rows of each rate present go through one resample together."""
    fs = np.asarray(fs_batch).reshape(-1)
    T_out = batch.shape[-1]
    rates = sorted({int(r) for r in fs})
    if rates == [int(target_fs)]:
        return batch
    out = torch.empty_like(batch)
    for r in rates:
        rows = torch.from_numpy(np.flatnonzero(fs == r)).to(batch.device)
        out[rows] = _fit(resample(batch[rows], r, target_fs), T_out)
    return out


# ----------------------------------------------------------------- A-weighting

@functools.lru_cache(maxsize=4)
def _design_aweighting(fs: int, ntaps: int = 101) -> np.ndarray:
    """FIR least-squares fit of the IEC 61672 A-weighting curve (bilinear
    analog zpk -> freqz -> firls)."""
    f1, f2, f3, f4 = 20.598997, 107.65265, 737.86223, 12194.217
    A1000 = 1.9997
    num = [(2 * np.pi * f4) ** 2 * 10 ** (A1000 / 20), 0, 0, 0, 0]
    den = np.polymul([1, 4 * np.pi * f4, (2 * np.pi * f4) ** 2],
                     [1, 4 * np.pi * f1, (2 * np.pi * f1) ** 2])
    den = np.polymul(np.polymul(den, [1, 2 * np.pi * f3]), [1, 2 * np.pi * f2])
    b, a = scipy.signal.bilinear(num, den, fs=fs)
    w, h = scipy.signal.freqz(b, a, worN=512, fs=fs)
    taps = scipy.signal.firls(ntaps, w, np.abs(h), fs=fs)
    return taps.astype(np.float32)


def a_weighting_filter(fs: int, ntaps: int = 101) -> Callable[[torch.Tensor], torch.Tensor]:
    """err -> A-weighted err along the last axis (a correlation with the taps,
    padded (k//2, (k-1)//2)), for the loss's ``error_filter`` hook."""
    taps = torch.from_numpy(_design_aweighting(int(fs), int(ntaps)))
    k = taps.shape[0]
    on_device: Dict[tuple, torch.Tensor] = {}

    def apply(x: torch.Tensor) -> torch.Tensor:
        key = (x.device, x.dtype)
        if key not in on_device:        # copied once: a capture cannot copy from the host
            on_device[key] = taps.to(x.device, x.dtype).reshape(1, 1, k)
        lead, T = x.shape[:-1], x.shape[-1]
        z = F.pad(x.reshape(-1, 1, T), (k // 2, (k - 1) // 2))
        y = F.conv1d(z, on_device[key])
        return y.reshape(lead + (T,))

    return apply


# ------------------------------------------------------------------------ EMA

def ema_rate_at(it: int, batch: int, ema_rate: float, ema_rampup: Optional[int]) -> float:
    """Effective EMA decay with warmup: t = it * batch,
    rate = min(ema_rate, (1 + t) / (10 + t)) under rampup."""
    if ema_rampup is None:
        return ema_rate
    t = it * batch
    return min(ema_rate, (1 + t) / (10 + t))


class EMAWarmup:
    """Power-function EMA warmup schedule (defined by the reference and not
    used by its trainer; kept for API parity)."""

    def __init__(self, inv_gamma: float = 1.0, power: float = 1.0,
                 min_value: float = 0.0, max_value: float = 1.0,
                 start_at: int = 0, last_epoch: int = 0):
        self.inv_gamma, self.power = inv_gamma, power
        self.min_value, self.max_value = min_value, max_value
        self.start_at, self.last_epoch = start_at, last_epoch

    def get_value(self) -> float:
        epoch = max(0, self.last_epoch - self.start_at)
        value = 1 - (1 + epoch / self.inv_gamma) ** -self.power
        return 0.0 if epoch < 0 else min(self.max_value, max(self.min_value, value))

    def step(self) -> None:
        self.last_epoch += 1

    def state_dict(self) -> Dict:
        return dict(self.__dict__)

    def load_state_dict(self, state: Dict) -> None:
        self.__dict__.update(state)


# ----------------------------------------------------------------- augmentation

def augment_draws(B: int, aug_cfg, gen: Optional[torch.Generator] = None, device=None,
                  sign: Optional[torch.Tensor] = None,
                  gain_db: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The draws ``augment`` makes for B rows under ``aug_cfg``, in its
    order: the polarity ``sign`` [B, 1] of +-1 and the ``gain_db`` [B, 1],
    each only where its augmentation is on, and the given one instead of a
    draw from ``gen``."""
    out: Dict[str, torch.Tensor] = {}
    if aug_cfg is None:
        return out
    ps = aug_cfg.get("pitch_shift", None)
    if ps is not None and bool(ps.get("use", False)):
        # the reference configs carry this key and no implementation reads it;
        # an enabled-and-ignored capability must fail loudly
        raise NotImplementedError(
            "augmentations.pitch_shift.use=True is not implemented "
            "(the reference never implements it either); set use=False "
            "or remove the key.")
    if bool(aug_cfg.get("rev_polarity", False)):
        if sign is None:
            flip = torch.rand((B, 1), generator=gen, device=device) < 0.5
            sign = 1.0 - 2.0 * flip.float()
        out["sign"] = sign
    gain = aug_cfg.get("gain", None)
    if gain is not None and bool(gain.get("use", False)):
        if gain_db is None:
            lo, hi = float(gain.get("min_db", -3)), float(gain.get("max_db", 3))
            gain_db = lo + (hi - lo) * torch.rand((B, 1), generator=gen, device=device)
        out["gain_db"] = gain_db
    return out


def augment(audio: torch.Tensor, aug_cfg, gen: Optional[torch.Generator] = None,
            sign: Optional[torch.Tensor] = None,
            gain_db: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batch augmentations of [B, T]: a per-row polarity flip (exact) and a
    uniform gain in dB. ``sign`` [B, 1] of +-1 and ``gain_db`` [B, 1] replace
    the draws from ``gen`` when given (``augment_draws``)."""
    d = augment_draws(audio.shape[0], aug_cfg, gen, audio.device, sign, gain_db)
    if "sign" in d:
        audio = audio * d["sign"]
    if "gain_db" in d:
        audio = audio * 10.0 ** (d["gain_db"] / 20.0)
    return audio
