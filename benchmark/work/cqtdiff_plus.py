"""The work of one forward of the CQTDiff+ octave-CQT U-Net, counted from the
configuration's shapes (the architecture ``cqtdiff_plus``; ``counts.py``
dispatches here by name).

Multiply-adds of every convolution, dense layer, attention product and FIR
resampler tap at the published widths, whatever implements them (the port
runs a resampler as a banded matrix product and folds the dilated convs
into the batch; neither changes the count). The CQT's and its inverse's
FFTs, the norms and the elementwise passes are left out.

The fused norm x adaLN x GELU function runs once per dilated layer of every
adaLN block, on the block's activation [B, F, T, C]: one launch of R = F T
rows of C channels.
"""
from __future__ import annotations

import functools
import json
from typing import Dict, List, Tuple

from reference.cqt import CQT

FIR_TAPS = 8          # the cubic resampler's taps


@functools.lru_cache(maxsize=8)
def octave_frames(num_octs: int, bins: int, fs: float, audio_len: int, beta: float) -> Tuple[int, ...]:
    """Frames M_j of each octave, low to high, of the CQT design."""
    return tuple(CQT(num_octs, bins, fs, audio_len, ("kaiser", beta)).M)


def _frames(cfg: dict) -> Tuple[int, ...]:
    n, e = cfg["network"], cfg["exp"]
    return octave_frames(int(n["cqt"]["num_octs"]), int(n["cqt"]["bins_per_oct"]),
                         float(e["sample_rate"]), int(e["audio_len"]), float(n["cqt"]["beta"]))


def _block(ops: List, launches: List, F: int, T: int, din: int, dout: int, emb: int,
           dils: int, kernel: int, proj_after: bool = False, heads: int = 0) -> None:
    """Append one adaLN block's (kind, macs) at batch 1 to ``ops`` and its
    fused launches (R, C) to ``launches``."""
    N = din if proj_after else dout
    rows = F * T
    if din != N:
        ops.append(("conv1x1", rows * din * N))
    if heads:
        ops.append(("dense", 2 * emb * N))                       # affine2, gate2
        ops.append(("conv1x1", rows * N * heads))                # proj_in
        ops.append(("dense", T * (heads * F) * (2 * heads * F)))  # qk
        ops.append(("attention", 2 * heads * T * T * F))         # QK^T and attn V
        ops.append(("conv1x1", rows * heads * N))                # proj_out
    for _ in range(dils):
        ops.append(("dense", 2 * emb * N))                       # affine, gate
        ops.append(("conv" if kernel > 1 else "conv1x1", rows * N * N * kernel))
        launches.append((rows, N))
    if proj_after and N != dout:
        ops.append(("conv1x1", rows * N * dout))
    if din != dout:
        ops.append(("conv1x1", rows * din * dout))


@functools.lru_cache(maxsize=8)
def _walk(key: str) -> Tuple[Tuple, Tuple]:
    cfg = json.loads(key)
    n = cfg["network"]
    O, bins = int(n["cqt"]["num_octs"]), int(n["cqt"]["bins_per_oct"])
    Ns, dils, attl = list(n["Ns"]), list(n["num_dils"]), list(n["attention_layers"])
    emb = int(n["emb_dim"])
    heads = int(n.get("attention_dict", {}).get("num_heads", 8))
    M = _frames(cfg)
    T = [M[O - 1 - i] for i in range(O)]          # frames of encoder level i
    ops: List = [("dense", 64 * 128 + 128 * 256 + 256 * emb)]
    launches: List = []
    for i in range(O):
        d0 = Ns[0] if i == 0 else Ns[i - 1]
        F = (i + 1) * bins
        _block(ops, launches, bins, T[i], 2, d0, emb, 1, 1)
        _block(ops, launches, F, T[i], d0, Ns[i], emb, dils[i], 15,
               heads=heads if attl[i] else 0)
        if i < O - 1:   # X and the raw-CQT pyramid down to the next level
            ops.append(("fir", F * (T[i] // 2) * (Ns[i] + 2) * FIR_TAPS))
        nxt = min(i + 1, O - 1)
        ops.append(("conv", (i + 1) * bins * T[nxt] * 2 * Ns[i] * 15))     # pyramid conv
    F = O * bins
    _block(ops, launches, F, T[-1], Ns[-1], Ns[-1], emb, dils[-1], 15,
           heads=heads if attl[-1] else 0)
    _block(ops, launches, F, T[-1], Ns[-1], 2, emb, 1, 1, proj_after=True)
    for i in range(O):
        oi = O - 1 - i
        dout = Ns[oi - 1] if oi > 0 else Ns[0]
        F = (oi + 1) * bins
        _block(ops, launches, F, T[oi], 2 * Ns[oi], dout, emb, dils[oi], 15,
               heads=heads if attl[oi] else 0)
        _block(ops, launches, F, T[oi], dout, 2, emb, 1, 1, proj_after=True)
        if i < O - 1:   # X and the output pyramid up to the next level
            ops.append(("fir", (F - bins) * (2 * T[oi]) * (dout + 2) * FIR_TAPS // 2))
    return tuple(ops), tuple(launches)


def _key(cfg: dict) -> str:
    return json.dumps({"network": cfg["network"], "exp": cfg["exp"]}, sort_keys=True)


def forward_macs(cfg: dict) -> Dict[str, int]:
    """Multiply-adds of one forward at batch 1, by kind."""
    out: Dict[str, int] = {}
    for kind, macs in _walk(_key(cfg))[0]:
        out[kind] = out.get(kind, 0) + int(macs)
    return out


def fused_launches(cfg: dict) -> List[Tuple[int, int]]:
    """(R, C) of every fused launch of one forward."""
    return list(_walk(_key(cfg))[1])
