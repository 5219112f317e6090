"""Plain reference of the octave-banded invertible CQT (painless NSGT design).

A frozen copy of the design in ``aid_tpu_torch/ops/cqt.py`` (the port's
``CQT``), kept to the three operators the U-Net and the sampler use:
``fwd`` (analysis into the octave bands), ``bwd`` (synthesis from them) and
``apply_hpf_DC`` (the band limit of the sampler's estimate). The design is
host numpy in float64; the operators run in float32 / complex64 torch.
Imports nothing of the port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import numpy as np
import torch


def _next_smooth(n: int) -> int:
    """Smallest integer >= n whose prime factors are all in {2, 3, 5, 7}."""
    def smooth(m: int) -> bool:
        for p in (2, 3, 5, 7):
            while m % p == 0:
                m //= p
        return m == 1

    while not smooth(n):
        n += 1
    return n


def _window(kind, x: np.ndarray) -> np.ndarray:
    """Symmetric window on x in [-0.5, 0.5], zero outside."""
    inside = np.abs(x) <= 0.5
    name, beta = (kind[0], float(kind[1])) if isinstance(kind, (tuple, list)) else (kind, 0.0)
    if name == "hann":
        w = 0.5 + 0.5 * np.cos(2 * np.pi * x)
    elif name == "kaiser":
        w = np.i0(beta * np.sqrt(np.clip(1.0 - (2.0 * x) ** 2, 0.0, None))) / np.i0(beta)
    else:
        raise ValueError(f"unknown window {kind!r}")
    return np.where(inside, w, 0.0)


@dataclasses.dataclass(frozen=True)
class _Band:
    center: int
    offsets: np.ndarray
    win: np.ndarray
    M: int


class CQT:
    def __init__(self, num_octs: int, bins_per_oct: int, fs: float, audio_len: int,
                 window=("kaiser", 1.0)):
        O, B = num_octs, bins_per_oct
        self.num_octs, self.bins_per_oct = O, B
        base = 2 ** (O + 5)
        Ls = _next_smooth(max(1, math.ceil(audio_len / base))) * base
        self.Ls = Ls
        nyq = fs / 2.0
        K = O * B
        f = nyq / 2.0 ** O * 2.0 ** (np.arange(-1, K + 1) / B)
        f[-1] = min(f[-1], nyq)
        to_bin = Ls / fs
        bands: List[_Band] = []
        for k in range(K):
            lo_hz, c_hz, hi_hz = f[k], f[k + 1], f[k + 2]
            c = int(round(c_hz * to_bin))
            lo, hi = int(math.ceil(lo_hz * to_bin)), int(math.floor(hi_hz * to_bin))
            x = (np.arange(lo, hi + 1) - c_hz * to_bin) / ((hi_hz - lo_hz) * to_bin)
            bands.append(_Band(c, np.arange(lo, hi + 1) - c, _window(window, x), 0))
        need = 1
        for j in range(O):
            need = max(need, max(len(bands[j * B + b].offsets) for b in range(B)) * 2 ** (O - 1 - j))
        M_top = 1 << (need - 1).bit_length()
        self.M = [M_top // 2 ** (O - 1 - j) for j in range(O)]
        bands = [dataclasses.replace(bd, M=self.M[k // B]) for k, bd in enumerate(bands)]

        b0 = f[1] * to_bin
        offs = np.arange(int(math.ceil(-b0)) + 1, int(math.floor(b0)))
        dc = _Band(0, offs, _window(window, offs / (2.0 * b0)), 1 << (len(offs) - 1).bit_length())
        c_nyq = Ls // 2
        bK = f[K] * to_bin
        offs = np.arange(int(math.ceil(bK)) + 1, int(math.floor(2 * c_nyq - bK))) - c_nyq
        nyq_b = _Band(c_nyq, offs, _window(window, offs / (2.0 * (c_nyq - bK))),
                      1 << (len(offs) - 1).bit_length())
        every = [dc] + bands + [nyq_b]
        every = [dataclasses.replace(bd, win=bd.win * bd.M / math.sqrt(Ls * float(np.sum(bd.win ** 2))))
                 for bd in every]
        bands = every[1:-1]
        D = np.zeros(Ls)
        for bd in every:
            pos = (bd.center + bd.offsets) % Ls
            D[pos] += bd.win ** 2
            D[(-pos) % Ls] += bd.win ** 2

        H = Ls // 2 + 1
        self._H = H
        self._oct = []
        for j in range(O):
            M = self.M[j]
            starts = np.zeros(B, np.int64)
            lens = np.zeros(B, np.int64)
            win_a = np.zeros((B, M), np.float32)
            win_s = np.zeros((B, M), np.float32)
            phase = np.zeros((B, M), np.complex64)
            for b, bd in enumerate(bands[j * B:(j + 1) * B]):
                pos = bd.center + bd.offsets
                L = len(pos)
                starts[b], lens[b] = pos[0], L
                win_a[b, :L] = bd.win
                win_s[b, :L] = bd.win / D[pos]
                r = int((pos[0] - bd.center) % M)
                phase[b] = np.exp(2j * np.pi * r * np.arange(M) / M)
            bins = starts[:, None] + np.arange(M)[None, :]
            bins = np.where(np.arange(M)[None, :] < lens[:, None], bins, H)
            self._oct.append(dict(starts=starts, win_a=win_a, win_s=win_s, phase=phase,
                                  phase_c=np.conj(phase), bins=bins.reshape(-1)))
        mask = np.zeros(Ls)
        for bd in bands:
            pos = (bd.center + bd.offsets) % Ls
            mask[pos] += bd.win ** 2 / D[pos]
            mask[(-pos) % Ls] += bd.win ** 2 / D[(-pos) % Ls]
        self._hpf = np.asarray(mask[:H], np.float32)
        self._dev = {}

    def _t(self, device):
        device = torch.device(device)
        if device not in self._dev:
            self._dev[device] = dict(
                hpf=torch.from_numpy(self._hpf).to(device),
                octs=[{k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in o.items()}
                      for o in self._oct])
        return self._dev[device]

    def _pad(self, x: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.pad(x, (0, self.Ls - x.shape[-1]))

    def fwd(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x real [..., T] -> low->high octave list of complex [..., bins, M_j]."""
        X = torch.fft.rfft(self._pad(x).float())
        out = []
        for j, o in enumerate(self._t(x.device)["octs"]):
            M = self.M[j]
            V = torch.nn.functional.pad(X, (0, M)).unfold(-1, M, 1).index_select(-2, o["starts"])
            out.append(torch.fft.ifft(V * o["win_a"], dim=-1) * o["phase"])
        return out

    def bwd(self, coeffs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Octave bands -> real [..., Ls]."""
        lead = coeffs[0].shape[:-2]
        half = None
        for c, o in zip(coeffs, self._t(coeffs[0].device)["octs"]):
            U = (torch.fft.fft(c.to(torch.complex64) * o["phase_c"], dim=-1) * o["win_s"]).reshape(*lead, -1)
            if half is None:
                half = U.new_zeros(*lead, self._H + 1)
            half = half.index_add(-1, o["bins"], U)
        return torch.fft.irfft(half[..., :self._H], n=self.Ls)

    def apply_hpf_DC(self, x: torch.Tensor) -> torch.Tensor:
        """x without its DC- and Nyquist-band content, same length."""
        T = x.shape[-1]
        y = torch.fft.irfft(torch.fft.rfft(self._pad(x).float()) * self._t(x.device)["hpf"], n=self.Ls)
        return y[..., :T]
