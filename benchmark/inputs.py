"""What the benchmark makes from ``--seed`` and hands to both the program
and the reference: the weights, the audio, the gap masks and the training
batches. Nothing here reads anything the program made.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def substream(seed: int, *path: int) -> int:
    """A 63-bit seed for the part ``path`` of the run seeded with ``seed``."""
    return int(np.random.SeedSequence([int(seed) % 2 ** 64, *path]).generate_state(1, np.uint64)[0]) >> 1


def weights(shapes: Sequence[Tuple[str, Tuple[int, ...]]], seed: int, device) -> Dict[str, torch.Tensor]:
    """Float32 weights for the named ``shapes`` (taken in name order), made on
    ``device`` from one generator in two calls: every matrix and kernel
    uniform in +-1/sqrt(fan in) (kaiming-uniform x sqrt(1/3), the gates at
    the main layers' scale, as a trained net's), biases 0, norm gains 1, the
    noise embedding's Fourier frequencies 16 N(0, 1)."""
    shapes = sorted((n, tuple(s)) for n, s in shapes)
    normal = [n for n, _ in shapes if n.endswith("RFF_freq")]
    size = {n: math.prod(s) for n, s in shapes}
    n_u = sum(size[n] for n, s in shapes if len(s) >= 2 and n not in normal)
    gen = torch.Generator(device=device).manual_seed(substream(seed, 0))
    u = torch.rand(n_u, generator=gen, device=device).mul_(2.0).sub_(1.0)
    g = torch.randn(sum(size[n] for n in normal), generator=gen, device=device)
    out, iu, ig = {}, 0, 0
    for name, shape in shapes:
        k = size[name]
        if name in normal:
            out[name] = (16.0 * g[ig:ig + k]).reshape(shape)
            ig += k
        elif len(shape) >= 2:
            out[name] = (u[iu:iu + k] / math.sqrt(k // shape[0])).reshape(shape)
            iu += k
        elif name.endswith("gamma"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def music(n: int, fs: float, seed: int, notes_per_s: float = 4.0, partials: int = 6,
          rms: float = 0.1) -> np.ndarray:
    """Music-like float32 audio of ``n`` samples: notes at random onsets,
    each a harmonic series (MIDI 36-84, partial k at 1/k) under an
    exponential decay of 0.2-1.5 s, scaled to ``rms``."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    out = np.zeros(n)
    count = max(1, int(round(notes_per_s * n / fs)))
    for onset, midi, decay in zip(rng.uniform(-0.5, n / fs, count), rng.integers(36, 85, count),
                                  rng.uniform(0.2, 1.5, count)):
        f0 = 440.0 * 2.0 ** ((midi - 69) / 12.0)
        i0 = max(0, int(onset * fs))
        i1 = min(n, i0 + int(6 * decay * fs))
        tt = t[i0:i1] - onset
        env = np.exp(-tt / decay)
        phase = rng.uniform(0, 2 * np.pi, partials)
        for k in range(1, partials + 1):
            if k * f0 < fs / 2:
                out[i0:i1] += env * np.sin(2 * np.pi * k * f0 * tt + phase[k - 1]) / k
    return (out * (rms / max(float(np.sqrt(np.mean(out ** 2))), 1e-9))).astype(np.float32)


def gap_mask(n: int, fs: float, gaps: Sequence[dict], seed: int) -> np.ndarray:
    """Ones with a gap of zeros for each entry of ``gaps``: its length drawn
    from ``ms`` [lo, hi] and its centre from ``centre_s`` [lo, hi]."""
    rng = np.random.default_rng(seed)
    m = np.ones(n, np.float32)
    for g in gaps:
        length = int(rng.uniform(*g["ms"]) / 1000.0 * fs)
        c = int(rng.uniform(*g["centre_s"]) * fs)
        m[max(0, c - length // 2):min(n, c - length // 2 + length)] = 0.0
    return m


def center_gap_mask(batch: int, L: int, fs: float, gap_ms: float = 1500.0) -> np.ndarray:
    """[batch, L] ones with a ``gap_ms`` gap of zeros in the middle
    (a copy of ``bench_torch.center_gap_mask``)."""
    gap = int(gap_ms / 1000 * fs)
    m = np.ones((batch, L), np.float32)
    s = (L - gap) // 2
    m[:, s:s + gap] = 0.0
    return m


def train_batches(count: int, rows: int, L: int, seed: int) -> List[np.ndarray]:
    """``count`` distinct host batches [rows, L] of N(0, 0.05^2) audio (the
    synthetic feed of ``scripts/bench_train_torch.py``)."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((rows, L)) * 0.05).astype(np.float32) for _ in range(count)]
