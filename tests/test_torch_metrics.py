"""The port's objective metrics against the JAX package's
``testing/metrics.py`` on the same arrays and wav files, to 1e-5 relative.

The JAX package's log-mel embedder reads its |STFT| as [frames, F] where
``_stft_mag`` returns [F, frames], so its "mel" filterbank runs over time;
the port takes [frames, F]. The FAD-related checks therefore hold the port
to the JAX embedder with that one layout corrected (``_stft_mag``
transposed), and one test shows that the two differ without it.
"""
import json
import os

import numpy as np
import pytest

from aid_tpu.testing import metrics as jm
from aid_tpu_torch.data import audio_io
from aid_tpu_torch.testing import metrics as tm
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
FS = 22050


def _pair(seed, n=8192, noise=0.05):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = (0.2 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(n)).astype(np.float32)
    return x, (x + noise * rng.standard_normal(n)).astype(np.float32)


def _close(a, b, tol=TOL):
    return abs(a - b) <= tol * max(abs(b), 1e-12)


@pytest.fixture
def jax_fixed_layout(monkeypatch):
    orig = jm._stft_mag
    monkeypatch.setattr(jm, "_stft_mag", lambda x, n_fft=1024, hop=256: orig(x, n_fft, hop).T)


@pytest.mark.parametrize("name", ["lsd", "snr", "spectral_convergence"])
@pytest.mark.parametrize("seed", [0, 1])
def test_scalar_metrics_match_jax(name, seed):
    x, y = _pair(seed, noise=0.02 + 0.1 * seed)
    got, ref = getattr(tm, name)(x, y), getattr(jm, name)(x, y)
    assert _close(got, ref), (got, ref)


def test_gap_snr_and_identity():
    x, y = _pair(2)
    region = slice(2000, 3000)
    assert _close(tm.snr(x, y, region), jm.snr(x, y, region))
    assert tm.lsd(x, x) < 1e-4 and tm.snr(x, x) > 100 and tm.spectral_convergence(x, x) < 1e-6


def test_logmel_embedder_matches_jax_with_the_layout_fixed(jax_fixed_layout):
    x, _ = _pair(3, n=3 * FS)
    got = tm.logmel_embedder(x, FS)
    ref = jm.logmel_embedder(x, FS)
    assert got.shape == ref.shape == (8, 64 * 16)      # 130 frames of hop 512
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


def test_jax_logmel_embedder_runs_its_filterbank_over_time():
    x, _ = _pair(3, n=3 * FS)
    assert tm.logmel_embedder(x, FS).shape == (8, 1024)
    assert jm.logmel_embedder(x, FS).shape == (32, 1024)    # 513 bins // 16


def test_frechet_distance_and_fad_from_embeddings():
    d = tm.frechet_distance(np.array([0.0]), np.array([[1.0]]), np.array([3.0]),
                            np.array([[4.0]]))
    assert d == pytest.approx(9.0 + 1.0 + 4.0 - 2 * 2.0)
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal((40, 6)), rng.standard_normal((30, 6)) * 1.5 + 0.3
    assert _close(tm.fad_from_embeddings(a, b), jm.fad_from_embeddings(a, b))


@pytest.fixture
def wav_tree(tmp_path):
    """A tester mode tree: original/ and reconstructed/ with three files."""
    d = tmp_path / "inpainting"
    for sub in ("original", "reconstructed"):
        (d / sub).mkdir(parents=True)
    for i in range(3):
        x, y = _pair(10 + i, n=2 * FS, noise=0.02 * (i + 1))
        audio_io.write(str(d / "original" / f"f{i}.wav"), x, FS)
        audio_io.write(str(d / "reconstructed" / f"f{i}.wav"), y, FS)
    return str(d)


def test_fad_matches_jax_with_the_layout_fixed(wav_tree, jax_fixed_layout):
    a, b = os.path.join(wav_tree, "original"), os.path.join(wav_tree, "reconstructed")
    assert tm.fad(a, a) < 1e-3
    assert _close(tm.fad(a, b), jm.fad(a, b))


def test_score_directory_matches_jax(wav_tree):
    got = tm.score_directory(wav_tree)
    with open(os.path.join(wav_tree, "metrics.json")) as f:
        assert json.load(f) == json.loads(json.dumps(got))
    ref = jm.score_directory(wav_tree, out_json=os.path.join(wav_tree, "jax.json"))
    assert set(got) == set(ref)
    for k in ref:
        if k == "__fad__":
            assert np.isfinite(got[k])
            continue
        for m in ("lsd", "snr", "spectral_convergence"):
            assert _close(got[k][m], ref[k][m]), (k, m)
