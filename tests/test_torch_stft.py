"""The port's STFT, inverse STFT and spectral mask against the JAX
package's ``ops/stft.py`` and ``degradations.spectral_mask``, gradients
included (spectral guidance backpropagates through both). f32 on the CPU,
inputs from a numpy seed; tolerance 1e-5 relative to the largest value."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aid_tpu.ops import stft as jstft
from aid_tpu.sampling import degradations as jdegr
from aid_tpu_torch.ops import stft as tstft
from aid_tpu_torch.sampling import degradations as tdegr
from aid_tpu_torch.utils.containers import EasyDict
from tests.test_torch_unet import rel_err
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
# (n_fft, hop, win_length, signal length): the tester's 1024/256 and a
# window shorter than the FFT
SHAPES = [(1024, 256, 1024, 3072), (256, 64, 256, 2048), (256, 100, 200, 1900)]


def _x(seed, n, batch=2):
    return (np.random.default_rng(seed).standard_normal((batch, n)) * 0.1).astype(np.float32)


def test_hann_window_is_torch_periodic_and_jax():
    for n in (8, 1024):
        w = tstft.hann_window(n)
        torch.testing.assert_close(w, torch.hann_window(n), rtol=0, atol=2e-7)
        np.testing.assert_allclose(w.numpy(), np.asarray(jstft.hann_window(n)), atol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_stft_and_istft_match_jax(shape):
    n_fft, hop, win, n = shape
    x = _x(1, n)
    got = tstft.stft(torch.from_numpy(x), n_fft, hop, win)
    ref = np.asarray(jstft.stft(jnp.asarray(x), n_fft, hop, win))
    assert got.shape == ref.shape and rel_err(got.numpy(), ref) < TOL
    spec = (ref * np.exp(1j * np.random.default_rng(2).uniform(0, 6.3, ref.shape))).astype(
        np.complex64)                               # not the STFT of any signal
    got = tstft.istft(torch.from_numpy(spec), n_fft, hop, win, length=n)
    ref = np.asarray(jstft.istft(jnp.asarray(spec), n_fft, hop, win, length=n))
    assert got.shape == ref.shape and rel_err(got.numpy(), ref) < TOL


@pytest.mark.parametrize("shape", SHAPES[:2], ids=lambda s: "x".join(map(str, s)))
def test_round_trip(shape):
    n_fft, hop, win, n = shape
    x = torch.from_numpy(_x(3, n))
    y = tstft.istft(tstft.stft(x, n_fft, hop, win), n_fft, hop, win, length=n)
    assert rel_err(y.numpy(), x.numpy()) < TOL


def test_spectrogram_db_matches_jax():
    x = _x(4, 4096, batch=1)[0]
    got = tstft.spectrogram_db(torch.from_numpy(x))
    ref = np.asarray(jstft.spectrogram_db(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3)   # dB: 1e-3 dB ~ 1e-4 relative
    assert float(got.max()) == 0.0 and float(got.min()) >= -80.0


def _spectral_case():
    cfg = EasyDict(n_fft=256, hop_length=64, win_length=256)
    n = 2000
    frames = 1 + (n + 256 - n % 256) // 64
    mask = np.ones((129, frames), np.float32)
    mask[5:60, 10:25] = 0.0
    return cfg, n, mask


def test_spectral_mask_and_its_gradient_match_jax():
    """A(x) = iSTFT(mask * STFT(pad(x))) and d/dx of a weighted loss through
    it, as guidance takes it."""
    cfg, n, mask = _spectral_case()
    x, y = _x(5, n), _x(6, n)
    w = np.random.default_rng(7).uniform(0.5, 1.5, (2, n)).astype(np.float32)

    def jloss(x):
        return jnp.sum(w * (jdegr.spectral_mask(jnp.asarray(mask), cfg)(x) - y) ** 2)

    ref_y = np.asarray(jdegr.spectral_mask(jnp.asarray(mask), cfg)(jnp.asarray(x)))
    ref_g = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got_y = tdegr.spectral_mask(torch.from_numpy(mask), cfg)(xt)
    (got_g,) = torch.autograd.grad(
        (torch.from_numpy(w) * (got_y - torch.from_numpy(y)) ** 2).sum(), xt)
    assert rel_err(got_y.detach().numpy(), ref_y) < TOL
    assert rel_err(got_g.numpy(), ref_g) < TOL


def test_spectral_projector_and_magnitude_match_jax():
    cfg, n, mask = _spectral_case()
    x, y = _x(8, n), _x(9, n)
    jA = jdegr.spectral_mask(jnp.asarray(mask), cfg)
    tA = tdegr.spectral_mask(torch.from_numpy(mask), cfg)
    ref = np.asarray(jdegr.spectral_projector(jnp.asarray(y), jA)(jnp.asarray(x)))
    got = tdegr.spectral_projector(torch.from_numpy(y), tA)(torch.from_numpy(x))
    assert rel_err(got.numpy(), ref) < TOL
    ref = np.asarray(jdegr.stft_magnitude(cfg)(jnp.asarray(x)))
    got = tdegr.stft_magnitude(cfg)(torch.from_numpy(x))
    assert rel_err(got.numpy(), ref) < TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_hann_window_is_made_once_and_equals_the_uploaded_one(dtype):
    """The window is kept per (length, dtype, device), so an STFT inside a
    guided score copies nothing from the host; it equals the window the
    numpy formula uploads, bit for bit."""
    for n in (200, 1024):
        w = tstft.hann_window(n, dtype=dtype)
        assert tstft.hann_window(n, dtype=dtype, device="cpu") is w
        old = torch.as_tensor(0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n), dtype=dtype)
        assert w.dtype == dtype and torch.equal(w, old)
    assert tstft.hann_window(256) is not tstft.hann_window(256, dtype=torch.float64)
