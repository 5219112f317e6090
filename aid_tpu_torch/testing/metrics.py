"""Objective audio metrics (port of ``aid_tpu/testing/metrics.py``): LSD,
SNR, spectral convergence, Fréchet audio distance over a log-mel embedder,
and the scoring of a tester output tree.

The STFT is the port's (``ops/stft.py``), run on the host in f32; the
statistics are numpy.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from aid_tpu_torch.data import audio_io
from aid_tpu_torch.ops import stft as stft_ops


def _stft_mag(x: np.ndarray, n_fft: int = 1024, hop: int = 256) -> np.ndarray:
    """|STFT| [F, frames] of a mono signal."""
    X = stft_ops.stft(torch.as_tensor(np.asarray(x, np.float32))[None], n_fft, hop, n_fft)[0]
    return X.abs().numpy()


def lsd(reference: np.ndarray, estimate: np.ndarray, n_fft: int = 1024,
        hop: int = 256, eps: float = 1e-8) -> float:
    """Log-spectral distance in dB (lower is better): the mean over frames
    of the RMS over frequency of the log-power difference."""
    n = min(len(reference), len(estimate))
    R = _stft_mag(reference[:n], n_fft, hop)
    E = _stft_mag(estimate[:n], n_fft, hop)
    d = 10.0 * (np.log10(R ** 2 + eps) - np.log10(E ** 2 + eps))
    return float(np.mean(np.sqrt(np.mean(d ** 2, axis=0))))


def snr(reference: np.ndarray, estimate: np.ndarray,
        region: Optional[slice] = None) -> float:
    """Signal-to-noise ratio in dB, optionally over a region (a gap)."""
    r = np.asarray(reference, np.float64).reshape(-1)
    e = np.asarray(estimate, np.float64).reshape(-1)[: len(r)]
    if region is not None:
        r, e = r[region], e[region]
    err = r - e
    return float(10.0 * np.log10((np.sum(r ** 2) + 1e-12) / (np.sum(err ** 2) + 1e-12)))


def spectral_convergence(reference: np.ndarray, estimate: np.ndarray,
                         n_fft: int = 1024, hop: int = 256) -> float:
    """||R| - |E||_F / ||R||_F (lower is better)."""
    n = min(len(reference), len(estimate))
    R = _stft_mag(reference[:n], n_fft, hop)
    E = _stft_mag(estimate[:n], n_fft, hop)
    return float(np.linalg.norm(R - E) / (np.linalg.norm(R) + 1e-12))


def frechet_distance(mu_a: np.ndarray, cov_a: np.ndarray,
                     mu_b: np.ndarray, cov_b: np.ndarray) -> float:
    """|mu_a - mu_b|^2 + Tr(cov_a + cov_b - 2 (cov_a cov_b)^{1/2}); the
    square root's trace from the eigenvalues of sqrt(cov_a) cov_b
    sqrt(cov_a), clamped at 0."""
    diff = mu_a - mu_b
    wa, va = np.linalg.eigh(cov_a)
    sa = (va * np.sqrt(np.clip(wa, 0.0, None))) @ va.T
    wm = np.linalg.eigvalsh(sa @ cov_b @ sa)
    tr_sqrt = float(np.sum(np.sqrt(np.clip(wm, 0.0, None))))
    return float(diff @ diff + np.trace(cov_a) + np.trace(cov_b) - 2.0 * tr_sqrt)


def fad_from_embeddings(emb_a: np.ndarray, emb_b: np.ndarray) -> float:
    """FAD between two [N, D] embedding matrices."""
    emb_a = np.asarray(emb_a, np.float64).reshape(len(emb_a), -1)
    emb_b = np.asarray(emb_b, np.float64).reshape(len(emb_b), -1)
    cov_a = np.atleast_2d(np.cov(emb_a, rowvar=False))
    cov_b = np.atleast_2d(np.cov(emb_b, rowvar=False))
    return frechet_distance(emb_a.mean(axis=0), cov_a, emb_b.mean(axis=0), cov_b)


def logmel_embedder(audio: np.ndarray, fs: int, n_fft: int = 1024, hop: int = 512,
                    n_mels: int = 64, frames_per_embedding: int = 16) -> np.ndarray:
    """Log-mel patches [n_patches, n_mels * frames_per_embedding]: the
    built-in stand-in for the published FAD recipe's VGGish features
    (numbers compare only between runs with the same embedder)."""
    mag = _stft_mag(np.asarray(audio, np.float32).reshape(-1), n_fft, hop).T
    F = mag.shape[-1]
    mel_pts = 2595.0 * np.log10(1.0 + np.linspace(0, fs / 2, n_mels + 2) / 700.0)
    mel_pts = (10 ** (np.linspace(mel_pts[0], mel_pts[-1], n_mels + 2) / 2595.0) - 1.0) * 700.0
    bins = np.clip((mel_pts / (fs / 2) * (F - 1)).astype(int), 0, F - 1)
    fb = np.zeros((n_mels, F))
    for m in range(n_mels):
        lo, ce, hi = bins[m], bins[m + 1], bins[m + 2]
        if ce > lo:
            fb[m, lo:ce] = np.linspace(0, 1, ce - lo, endpoint=False)
        if hi > ce:
            fb[m, ce:hi] = np.linspace(1, 0, hi - ce, endpoint=False)
    mel = np.log(mag @ fb.T + 1e-6)                      # [frames, n_mels]
    k = frames_per_embedding
    n_patches = max(len(mel) // k, 1)
    mel = mel[: n_patches * k]
    if len(mel) < n_patches * k:
        mel = np.pad(mel, ((0, n_patches * k - len(mel)), (0, 0)))
    return mel.reshape(n_patches, -1)


def fad(dir_a: str, dir_b: str, embedder=None) -> float:
    """Fréchet audio distance between the wav files of two directories;
    ``embedder(audio, fs) -> [n, D]`` defaults to ``logmel_embedder``."""
    embedder = embedder or logmel_embedder

    def embed_dir(d):
        files = sorted(glob.glob(os.path.join(d, "*.wav")))
        if not files:
            raise FileNotFoundError(f"no wav files under {d}")
        out = []
        for f in files:
            x, fs = audio_io.read(f)
            out.append(np.asarray(embedder(x, fs)))
        return np.concatenate(out, axis=0)

    return fad_from_embeddings(embed_dir(dir_a), embed_dir(dir_b))


def score_directory(mode_dir: str, out_json: Optional[str] = None) -> Dict:
    """Score a tester output tree (``original/`` against ``reconstructed/``,
    file by file: LSD, SNR, spectral convergence; their means; the set's
    FAD) and write ``metrics.json`` beside it."""
    orig_dir = os.path.join(mode_dir, "original")
    rec_dir = os.path.join(mode_dir, "reconstructed")
    results = {}
    for f in sorted(glob.glob(os.path.join(orig_dir, "*.wav"))):
        name = os.path.basename(f)
        rf = os.path.join(rec_dir, name)
        if not os.path.exists(rf):
            continue
        ref, _ = audio_io.read(f)
        est, _ = audio_io.read(rf)
        results[name] = {"lsd": lsd(ref, est), "snr": snr(ref, est),
                         "spectral_convergence": spectral_convergence(ref, est)}
    if results:
        results["__mean__"] = {k: float(np.mean([v[k] for v in results.values()]))
                               for k in ("lsd", "snr", "spectral_convergence")}
        # a set statistic: where it cannot be computed the file says why
        try:
            results["__fad__"] = fad(orig_dir, rec_dir)
        except (ValueError, np.linalg.LinAlgError, FileNotFoundError) as e:
            results["__fad__"] = f"unavailable: {e}"
    with open(out_json or os.path.join(mode_dir, "metrics.json"), "w") as f:
        json.dump(results, f, indent=1)
    return results
