"""Invertible octave-banded Constant-Q transform (CQT-NSGT) in PyTorch.

Port of ``aid_tpu/ops/cqt.py``: the same painless nonstationary-Gabor design
(host-side numpy tables, identical to the JAX package's), the same "white"
coefficient normalisation, and the same network-facing operators:

    fwd(x[..., T])  -> list (low -> high octave) of complex [..., bins, M_j]
    bwd(list)       -> real [..., Ls] (caller crops to T)
    apply_hpf_DC(x) -> x band-limited to the octave bands (DC + Nyquist removed)

and the perfect-reconstruction pair with the DC and Nyquist bands,
``fwd_complete`` / ``bwd_complete`` (one full FFT, a gather of every band's
support with its analysis window and an ifft per band group; synthesis sums
each band's fft times its synthesis window into the full spectrum with
``index_add``, adds the Hermitian mirror and takes one inverse FFT).

Analysis is one rfft, then per octave the contiguous band slices of the half
spectrum (one gather of length-M windows), times the analysis window, an
ifft and a static phase ramp. Synthesis is per octave fft, times the
synthesis window, summed into the half spectrum at each band's support, and
one irfft. FFTs are library calls (cuFFT on the card). Gradients come from
torch autograd; the JAX package's hand VJPs are not needed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

import numpy as np
import torch


def _next_smooth(n: int) -> int:
    """Smallest integer >= n whose prime factors are all in {2,3,5,7}."""
    def is_smooth(m: int) -> bool:
        for p in (2, 3, 5, 7):
            while m % p == 0:
                m //= p
        return m == 1

    while not is_smooth(n):
        n += 1
    return n


def _window(kind, x: np.ndarray) -> np.ndarray:
    """Symmetric window on x in [-0.5, 0.5]; zero outside."""
    inside = np.abs(x) <= 0.5
    if isinstance(kind, (tuple, list)):
        name, beta = kind[0], float(kind[1])
    else:
        name, beta = kind, 0.0
    if name == "hann":
        w = 0.5 + 0.5 * np.cos(2 * np.pi * x)
    elif name == "kaiser":
        arg = np.clip(1.0 - (2.0 * x) ** 2, 0.0, None)
        w = np.i0(beta * np.sqrt(arg)) / np.i0(beta)
    elif name == "blackharr":
        w = (0.35872 + 0.48832 * np.cos(2 * np.pi * x)
             + 0.14128 * np.cos(4 * np.pi * x) + 0.01168 * np.cos(6 * np.pi * x))
    else:
        raise ValueError(f"unknown window {kind!r}")
    return np.where(inside, w, 0.0)


@dataclasses.dataclass(frozen=True)
class _Band:
    center: int          # FFT-bin index of the window peak (mod Ls)
    offsets: np.ndarray  # signed offsets; support positions are (center+o) mod Ls
    win: np.ndarray      # scaled analysis window sampled at offsets
    M: int               # temporal length (ifft size) for this band


class CQT:
    """Octave-mode invertible CQT (design identical to the JAX package's)."""

    def __init__(self, num_octs: int, bins_per_oct: int, fs: float,
                 audio_len: int, window="hann"):
        self.num_octs = num_octs
        self.bins_per_oct = bins_per_oct
        self.fs = float(fs)
        self.audio_len = int(audio_len)

        O, B = num_octs, bins_per_oct
        base = 2 ** (O + 5)
        mult = _next_smooth(max(1, math.ceil(audio_len / base)))
        Ls = mult * base
        self.Ls = Ls

        nyq_hz = self.fs / 2.0
        fmin = nyq_hz / (2.0 ** O)
        K = O * B
        f = fmin * 2.0 ** (np.arange(-1, K + 1) / B)  # f[0] = f_{-1}
        f[-1] = min(f[-1], nyq_hz)
        to_bin = Ls / self.fs

        bands: List[_Band] = []
        for k in range(K):
            lo_hz, c_hz, hi_hz = f[k], f[k + 1], f[k + 2]
            c = int(round(c_hz * to_bin))
            lo = int(math.ceil(lo_hz * to_bin))
            hi = int(math.floor(hi_hz * to_bin))
            offs = np.arange(lo, hi + 1) - c
            x = (np.arange(lo, hi + 1) - c_hz * to_bin) / ((hi_hz - lo_hz) * to_bin)
            bands.append(_Band(c, offs, _window(window, x), 0))

        # per-octave time resolution: power of two, halving per octave down
        need_top = 1
        for j in range(O):
            max_lg = max(len(bands[j * B + b].offsets) for b in range(B))
            need_top = max(need_top, max_lg * 2 ** (O - 1 - j))
        M_top = 1 << (need_top - 1).bit_length()
        self.M = [M_top // 2 ** (O - 1 - j) for j in range(O)]
        for j in range(O):
            for b in range(B):
                k = j * B + b
                if len(bands[k].offsets) > self.M[j]:
                    raise ValueError("painless condition violated")
                bands[k] = dataclasses.replace(bands[k], M=self.M[j])

        # DC band: centred at 0, support (-f_0, f_0)
        b0 = f[1] * to_bin
        lo, hi = int(math.ceil(-b0)) + 1, int(math.floor(b0)) - 1
        offs = np.arange(lo, hi + 1)
        dc = _Band(0, offs, _window(window, offs / (2.0 * b0)),
                   1 << (len(offs) - 1).bit_length())

        # Nyquist band: centred at Ls/2
        c_nyq = Ls // 2
        bK = f[K] * to_bin
        half = c_nyq - bK
        lo, hi = int(math.ceil(bK)) + 1, int(math.floor(2 * c_nyq - bK)) - 1
        offs = np.arange(lo, hi + 1) - c_nyq
        nyq = _Band(c_nyq, offs, _window(window, offs / (2.0 * half)),
                    1 << (len(offs) - 1).bit_length())

        # "white" normalisation: white noise keeps its variance
        all_bands = [dc] + bands + [nyq]
        for i, bd in enumerate(all_bands):
            s = bd.M / math.sqrt(Ls * float(np.sum(bd.win ** 2)))
            all_bands[i] = dataclasses.replace(bd, win=bd.win * s)
        dc, bands, nyq = all_bands[0], all_bands[1:-1], all_bands[-1]

        # frame diagonal over the full grid (direct + mirrored contributions)
        D = np.zeros(Ls)
        for bd in all_bands:
            pos = (bd.center + bd.offsets) % Ls
            D[pos] += bd.win ** 2
            D[(-pos) % Ls] += bd.win ** 2
        if not np.all(D[: Ls // 2 + 1] > 1e-10):
            raise ValueError("frame not invertible: uncovered frequencies")

        # full-spectrum gather positions and analysis/synthesis windows of
        # each band group (the octaves, DC, Nyquist), slot = offset mod M
        def pack(group: Sequence[_Band], M: int):
            idx = np.zeros((len(group), M), np.int64)
            wa = np.zeros((len(group), M), np.float32)
            ws = np.zeros((len(group), M), np.float32)
            for b, bd in enumerate(group):
                slots = bd.offsets % M
                if len(np.unique(slots)) != len(slots):
                    raise ValueError("painless condition violated (fold)")
                pos = (bd.center + bd.offsets) % Ls
                idx[b, slots] = pos
                wa[b, slots] = bd.win
                ws[b, slots] = bd.win / D[pos]
            return idx, wa, ws

        self._full = ([pack(bands[j * B:(j + 1) * B], self.M[j]) for j in range(O)]
                      + [pack([dc], dc.M), pack([nyq], nyq.M)])

        # per octave: band starts in the half spectrum, analysis/synthesis
        # windows over each band's M slots, and the slot-roll phase ramp
        H = Ls // 2 + 1
        self._H = H
        self._oct: List[dict] = []
        for j in range(O):
            M = self.M[j]
            starts = np.zeros(B, np.int64)
            lens = np.zeros(B, np.int64)
            win_a = np.zeros((B, M), np.float32)
            win_s = np.zeros((B, M), np.float32)
            phase = np.zeros((B, M), np.complex64)
            for b, bd in enumerate(bands[j * B:(j + 1) * B]):
                pos = bd.center + bd.offsets   # contiguous ascending, no wrap
                if not (np.all(np.diff(pos) == 1) and pos[0] >= 1
                        and pos[-1] <= Ls // 2):
                    raise ValueError("octave band support escapes the half spectrum")
                L = len(pos)
                starts[b], lens[b] = pos[0], L
                win_a[b, :L] = bd.win
                win_s[b, :L] = bd.win / D[pos]
                r = int((pos[0] - bd.center) % M)
                phase[b] = np.exp(2j * np.pi * r * np.arange(M) / M)
            # half-spectrum bin of every (band, slot); slots past a band's
            # support carry zero synthesis weight and go to a spare bin H
            bins = starts[:, None] + np.arange(M)[None, :]
            bins = np.where(np.arange(M)[None, :] < lens[:, None], bins, H)
            self._oct.append(dict(starts=starts, lens=lens, win_a=win_a,
                                  win_s=win_s, phase=phase, bins=bins))

        # apply_hpf_DC: band-subset analysis+synthesis is a diagonal
        # frequency mask in the painless case
        mask = np.zeros(Ls)
        for bd in bands:
            pos = (bd.center + bd.offsets) % Ls
            mask[pos] += bd.win ** 2 / D[pos]
            mpos = (-pos) % Ls
            mask[mpos] += bd.win ** 2 / D[mpos]
        self._hpf_mask = np.asarray(mask[:H], np.float32)
        self._dev: Dict[torch.device, dict] = {}

    # --------------------------------------------------------------- tables
    def _tables(self, device: torch.device) -> dict:
        """Design tables as tensors on ``device`` (built once per device)."""
        device = torch.device(device)
        t = self._dev.get(device)
        if t is None:
            t = dict(
                hpf=torch.from_numpy(self._hpf_mask).to(device),
                octs=[dict(
                    starts=torch.from_numpy(o["starts"]).to(device),
                    win_a=torch.from_numpy(o["win_a"]).to(device),
                    win_s=torch.from_numpy(o["win_s"]).to(device),
                    phase=torch.from_numpy(o["phase"]).to(device),
                    phase_c=torch.from_numpy(np.conj(o["phase"])).to(device),
                    bins=torch.from_numpy(o["bins"].reshape(-1)).to(device))
                    for o in self._oct],
                full=[tuple(torch.from_numpy(a).to(device) for a in grp)
                      for grp in self._full])
            self._dev[device] = t
        return t

    def _pad(self, x: torch.Tensor) -> torch.Tensor:
        T = x.shape[-1]
        if T > self.Ls:
            raise ValueError(
                f"input length {T} exceeds the designed transform length "
                f"Ls={self.Ls} (audio_len={self.audio_len}); build a CQT for "
                "the longer signal")
        if T < self.Ls:
            x = torch.nn.functional.pad(x, (0, self.Ls - T))
        return x

    # ------------------------------------------------------------ operators
    def fwd(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Analysis. x: real [..., T<=Ls] -> list low->high octave of
        complex64 [..., bins, M_j]."""
        tabs = self._tables(x.device)
        X = torch.fft.rfft(self._pad(x).float())
        out = []
        for j, o in enumerate(tabs["octs"]):
            M = self.M[j]
            # band b's slice is X[starts[b] : starts[b] + M]; the top bands
            # overrun the half spectrum, where their window is zero anyway
            Xp = torch.nn.functional.pad(X, (0, M))
            V = Xp.unfold(-1, M, 1).index_select(-2, o["starts"]) * o["win_a"]
            out.append(torch.fft.ifft(V, dim=-1) * o["phase"])
        return out

    def bwd(self, coeffs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Synthesis from the octave bands only -> real [..., Ls]."""
        tabs = self._tables(coeffs[0].device)
        lead = coeffs[0].shape[:-2]
        half = None
        for c, o in zip(coeffs, tabs["octs"]):
            U = torch.fft.fft(c.to(torch.complex64) * o["phase_c"], dim=-1) * o["win_s"]
            U = U.reshape(*lead, -1)
            if half is None:
                half = U.new_zeros(*lead, self._H + 1)
            half = half.index_add(-1, o["bins"], U)
        return torch.fft.irfft(half[..., : self._H], n=self.Ls)

    def fwd_complete(self, x: torch.Tensor):
        """Analysis including the DC and Nyquist bands: (dc [..., 1, M_dc],
        list low->high octave of [..., bins, M_j], nyq [..., 1, M_nyq]),
        complex64."""
        full = self._tables(x.device)["full"]
        X = torch.fft.fft(self._pad(x).float())
        out = [torch.fft.ifft(X[..., idx] * wa, dim=-1) for idx, wa, _ in full]
        return out[-2], out[:-2], out[-1]

    def bwd_complete(self, dc: torch.Tensor, coeffs: Sequence[torch.Tensor],
                     nyq: torch.Tensor) -> torch.Tensor:
        """Synthesis from every band (the inverse of ``fwd_complete``) ->
        real [..., Ls]."""
        full = self._tables(coeffs[0].device)["full"]
        lead = coeffs[0].shape[:-2]
        S = torch.zeros(*lead, self.Ls, dtype=torch.complex64, device=coeffs[0].device)
        for c, (idx, _, ws) in zip([*coeffs, dc, nyq], full):
            U = torch.fft.fft(c.to(torch.complex64), dim=-1) * ws
            S.index_add_(-1, idx.reshape(-1), U.reshape(*lead, -1))
        Z = S + torch.conj(S[..., (-torch.arange(self.Ls, device=S.device)) % self.Ls])
        return torch.fft.ifft(Z).real

    @property
    def octave_lengths(self) -> List[int]:
        return list(self.M)

    def apply_hpf_DC(self, x: torch.Tensor) -> torch.Tensor:
        """Remove DC-band and Nyquist-band content: rfft -> mask -> irfft,
        cropped back to x's length (the exact painless-case equivalent of
        bwd(fwd(x)))."""
        T = x.shape[-1]
        X = torch.fft.rfft(self._pad(x).float())
        y = torch.fft.irfft(X * self._tables(x.device)["hpf"], n=self.Ls)
        return y[..., :T]

    def __repr__(self) -> str:
        return (f"CQT(num_octs={self.num_octs}, bins_per_oct={self.bins_per_oct}, "
                f"fs={self.fs}, audio_len={self.audio_len}, Ls={self.Ls}, M={self.M})")


_CACHE: dict = {}


def get_cqt(num_octs: int, bins_per_oct: int, fs: float, audio_len: int,
            window="hann") -> CQT:
    """Cached CQT construction (the design is host-side numpy)."""
    if isinstance(window, list):
        window = tuple(window)
    key = (num_octs, bins_per_oct, float(fs), int(audio_len), window)
    if key not in _CACHE:
        _CACHE[key] = CQT(num_octs, bins_per_oct, fs, audio_len, window)
    return _CACHE[key]
