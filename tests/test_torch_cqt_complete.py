"""The port's perfect-reconstruction CQT pair (``fwd_complete`` /
``bwd_complete``, with the DC and Nyquist bands) against the JAX package's,
on the same numpy signals: every band within 1e-5 of JAX's relative to its
largest value, and the round trip within 2e-5 of the input (the gate of
``tests/test_cqt.py``). f32 throughout."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aid_tpu.ops.cqt import get_cqt as jax_get_cqt
from aid_tpu_torch.ops.cqt import get_cqt
from tests.torch_threads import one_torch_thread  # noqa: F401

DESIGNS = [(3, 8, 4096.0, 2048, "hann"),
           (4, 12, 16000.0, 3000, ("kaiser", 1.0)),
           (5, 16, 8000.0, 8192, ("kaiser", 1.0))]   # tests/test_cqt.py's design
BAND_TOL = 1e-5
ROUND_TRIP_TOL = 2e-5


def _signal(n, batch, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, n)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


@pytest.mark.parametrize("design", DESIGNS)
def test_fwd_complete_matches_jax(design):
    t, j = get_cqt(*design), jax_get_cqt(*design)
    x = _signal(t.audio_len - 5, 2, 0)            # shorter input: zero-padded
    dc, octs, nyq = t.fwd_complete(torch.from_numpy(x))
    jdc, jocts, jnyq = j.fwd_complete(jnp.asarray(x))
    assert len(octs) == len(jocts) == t.num_octs
    for a, b in zip([dc, *octs, nyq], [jdc, *jocts, jnyq]):
        assert a.dtype == torch.complex64
        assert _rel(a.numpy(), b) < BAND_TOL


@pytest.mark.parametrize("design", DESIGNS)
def test_bwd_complete_matches_jax(design):
    t, j = get_cqt(*design), jax_get_cqt(*design)
    dc, octs, nyq = j.fwd_complete(jnp.asarray(_signal(t.audio_len, 2, 1)))
    rng = np.random.default_rng(2)
    # arbitrary coefficients (not the analysis of a signal) exercise the
    # synthesis on its own
    coeffs = [np.asarray(c) + (0.1 * rng.standard_normal(c.shape)).astype(np.float32)
              for c in (dc, *octs, nyq)]
    got = t.bwd_complete(torch.from_numpy(coeffs[0]), [torch.from_numpy(c) for c in coeffs[1:-1]],
                         torch.from_numpy(coeffs[-1]))
    ref = j.bwd_complete(jnp.asarray(coeffs[0]), [jnp.asarray(c) for c in coeffs[1:-1]],
                         jnp.asarray(coeffs[-1]))
    assert tuple(got.shape) == (2, t.Ls)
    assert _rel(got.numpy(), ref) < BAND_TOL


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("batched", [False, True])
def test_perfect_reconstruction(design, batched):
    t = get_cqt(*design)
    x = _signal(t.audio_len, 2, 3)
    if not batched:
        x = x[0]
    else:
        x = x[:, None, :]
    y = t.bwd_complete(*t.fwd_complete(torch.from_numpy(x)))[..., : t.audio_len]
    assert float(np.abs(y.numpy() - x).max()) < ROUND_TRIP_TOL


@pytest.mark.parametrize("design", DESIGNS)
def test_octave_lengths(design):
    t, j = get_cqt(*design), jax_get_cqt(*design)
    assert t.octave_lengths == j.octave_lengths == t.M
