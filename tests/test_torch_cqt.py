"""The port's CQT against the JAX package's ``aid_tpu.ops.cqt.get_cqt``.

Forward, backward and the DC/Nyquist filter on tiny designs, and gradients
with respect to real inputs of real losses (the port's autograd against the
JAX package's hand VJPs). The two frameworks' complex-cotangent conventions
differ by a conjugate, so no complex cotangent is compared. f32 throughout:
tolerances are a few f32 ulps of each output's scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aid_tpu.ops.cqt import get_cqt as jax_get_cqt
from aid_tpu_torch.ops.cqt import get_cqt
from tests.torch_threads import one_torch_thread  # noqa: F401

DESIGNS = [(3, 8, 4096.0, 2048, "hann"),
           (4, 12, 16000.0, 3000, ("kaiser", 1.0))]
TOL = 2e-5


def _pair(design):
    return get_cqt(*design), jax_get_cqt(*design)


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = np.abs(b).max() + 1e-30
    assert np.abs(a - b).max() / scale < tol, np.abs(a - b).max() / scale


def _signal(cqt, seed=0, batch=2, length=None):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, length or cqt.audio_len)).astype(np.float32)


@pytest.mark.parametrize("design", DESIGNS)
def test_design_matches(design):
    t, j = _pair(design)
    assert (t.Ls, t.M) == (j.Ls, j.M)
    np.testing.assert_allclose(t._hpf_mask, j._hpf_mask, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("design", DESIGNS)
def test_fwd_matches_jax(design):
    t, j = _pair(design)
    x = _signal(t, length=t.audio_len - 7)        # shorter input: zero-padded
    got = t.fwd(torch.from_numpy(x))
    ref = j.fwd(jnp.asarray(x))
    assert len(got) == len(ref) == t.num_octs
    for a, b in zip(got, ref):
        _close(a.numpy(), b)


@pytest.mark.parametrize("design", DESIGNS)
def test_bwd_matches_jax(design):
    t, j = _pair(design)
    rng = np.random.default_rng(1)
    coeffs = [(rng.standard_normal((2, t.bins_per_oct, M))
               + 1j * rng.standard_normal((2, t.bins_per_oct, M))).astype(np.complex64)
              for M in t.M]
    got = t.bwd([torch.from_numpy(c) for c in coeffs]).numpy()
    ref = np.asarray(j.bwd([jnp.asarray(c) for c in coeffs]))
    _close(got, ref)


@pytest.mark.parametrize("design", DESIGNS)
def test_hpf_matches_jax_and_bwd_fwd(design):
    t, j = _pair(design)
    x = _signal(t, seed=2)
    got = t.apply_hpf_DC(torch.from_numpy(x))
    _close(got.numpy(), j.apply_hpf_DC(jnp.asarray(x)))
    # the painless frame: synthesis of the analysis is the filter
    bf = t.bwd(t.fwd(torch.from_numpy(x)))[..., : x.shape[-1]]
    _close(bf.numpy(), got.numpy(), 1e-5)


def _weights(cqt, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, cqt.bins_per_oct, M, 2)).astype(np.float32)
            for M in cqt.M]


@pytest.mark.parametrize("design", DESIGNS)
def test_fwd_gradient_matches_jax(design):
    """d/dx sum_j <W_j, (Re c_j, Im c_j)>, c = fwd(x): real x, real loss."""
    t, j = _pair(design)
    x = _signal(t, seed=3)
    W = _weights(t, 4)

    def jloss(x):
        return sum(jnp.sum(w[..., 0] * c.real + w[..., 1] * c.imag)
                   for w, c in zip(W, j.fwd(x)))

    ref = jax.grad(jloss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = sum((torch.from_numpy(w) * torch.view_as_real(c)).sum()
               for w, c in zip(W, t.fwd(xt)))
    (got,) = torch.autograd.grad(loss, xt)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("design", DESIGNS)
def test_bwd_gradient_matches_jax(design):
    """d/d(a_j, b_j) sum r * bwd(a + i b): real parameters, real loss."""
    t, j = _pair(design)
    rng = np.random.default_rng(5)
    ab = [rng.standard_normal((2, t.bins_per_oct, M, 2)).astype(np.float32) for M in t.M]
    r = rng.standard_normal((2, t.Ls)).astype(np.float32)

    def jloss(ab):
        return jnp.sum(r * j.bwd([a[..., 0] + 1j * a[..., 1] for a in ab]))

    ref = jax.grad(jloss)([jnp.asarray(a) for a in ab])
    abt = [torch.from_numpy(a).requires_grad_(True) for a in ab]
    loss = (torch.from_numpy(r) * t.bwd([torch.view_as_complex(a) for a in abt])).sum()
    got = torch.autograd.grad(loss, abt)
    for g, rf in zip(got, ref):
        _close(g.numpy(), rf)


@pytest.mark.parametrize("design", DESIGNS)
def test_hpf_gradient_matches_jax(design):
    t, j = _pair(design)
    x = _signal(t, seed=6)
    w = _signal(t, seed=7)
    ref = jax.grad(lambda x: jnp.sum(w * j.apply_hpf_DC(x) ** 2))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad((torch.from_numpy(w) * t.apply_hpf_DC(xt) ** 2).sum(), xt)
    _close(got.numpy(), ref)


def test_too_long_input_raises():
    t = get_cqt(*DESIGNS[0])
    with pytest.raises(ValueError):
        t.fwd(torch.zeros(1, t.Ls + 1))


@pytest.mark.slow
def test_flagship_design_matches_jax():
    design = (7, 64, 22050.0, 184184, ("kaiser", 1.0))
    t, j = _pair(design)
    assert (t.Ls, t.M) == (j.Ls, j.M) == (184320, [32, 64, 128, 256, 512, 1024, 2048])
    x = _signal(t, seed=8, batch=1)
    for a, b in zip(t.fwd(torch.from_numpy(x)), j.fwd(jnp.asarray(x))):
        _close(a.numpy(), b)
    _close(t.apply_hpf_DC(torch.from_numpy(x)).numpy(), j.apply_hpf_DC(jnp.asarray(x)))
