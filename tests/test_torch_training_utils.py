"""The port's training utilities, statistics and EDM training loss against
the JAX package's (``aid_tpu/training/{utils,stats}.py``,
``aid_tpu/diffusion/edm.py``). Inputs are made with numpy from a seed; where
JAX draws random numbers (sigma, noise, polarity), its draws are handed to
the port. Everything runs f32 on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aid_tpu.diffusion import edm as jedm
from aid_tpu.training import stats as jstats
from aid_tpu.training import utils as jutils
from aid_tpu_torch.diffusion import edm as tedm
from aid_tpu_torch.training import stats as tstats
from aid_tpu_torch.training import utils as tutils
from tests.torch_threads import one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


# f32 filters summed in other orders: outputs agree to a few ulps of their
# scale (unit-variance input, filters of gain ~1)
RESAMPLE_ATOL = 2e-5


@pytest.mark.parametrize("orig,new,T", [(44100, 22050, 4410), (48000, 22050, 4800),
                                        (48000, 22050, 4803), (22050, 44100, 1000)])
def test_resample_matches_jax(orig, new, T):
    """2:1, 147:320 (the 7681-tap 48 kHz path) and 1:2; at 4803 samples
    (147:320) and at 1:2 the strided conv falls one sample short of
    ceil(T up / down), which the edge pad fills."""
    x = np.random.default_rng(T).standard_normal((3, T)).astype(np.float32)
    ref = np.asarray(jutils.resample(jnp.asarray(x), orig, new))
    got = tutils.resample(_t(x), orig, new).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=RESAMPLE_ATOL, rtol=0)


def test_resample_batch_mixed_rates_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 4800)).astype(np.float32)
    fs = np.asarray([44100, 48000, 22050, 48000])
    ref = np.asarray(jutils.resample_batch(jnp.asarray(x), jnp.asarray(fs), 22050,
                                           rates=(22050, 44100, 48000)))
    got = tutils.resample_batch(_t(x), fs, 22050).numpy()
    np.testing.assert_allclose(got, ref, atol=RESAMPLE_ATOL, rtol=0)
    np.testing.assert_array_equal(got[2], x[2])         # already at the target rate
    same = tutils.resample_batch(_t(x), np.full(4, 22050), 22050)
    np.testing.assert_array_equal(same.numpy(), x)


def test_aweighting_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 3, 700)).astype(np.float32)
    ref = np.asarray(jutils.a_weighting_filter(22050, 101)(jnp.asarray(x)))
    got = tutils.a_weighting_filter(22050, 101)(_t(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_augment_with_injected_signs_matches_jax():
    """The polarity sign is drawn as in the JAX package (bernoulli on the
    second half of a split key) and injected into the port; gain augments
    likewise take an injected dB draw."""
    x = np.random.default_rng(3).standard_normal((6, 64)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    cfg = {"rev_polarity": True}
    ref = np.asarray(jutils.augment(key, jnp.asarray(x), cfg))
    _, k = jax.random.split(key)
    sign = np.where(np.asarray(jax.random.bernoulli(k, 0.5, (6, 1))), -1.0, 1.0)
    got = tutils.augment(_t(x), cfg, sign=_t(sign.astype(np.float32))).numpy()
    np.testing.assert_array_equal(got, ref)
    db = np.linspace(-3, 3, 6, dtype=np.float32)[:, None]
    g = tutils.augment(_t(x), {"gain": {"use": True}}, gain_db=_t(db)).numpy()
    np.testing.assert_allclose(g, x * 10.0 ** (db / 20.0), rtol=1e-6)
    # drawn from a generator: every row is flipped or kept
    r = tutils.augment(_t(x), cfg, torch.Generator().manual_seed(0)).numpy() / x
    assert all(np.allclose(v, 1.0) or np.allclose(v, -1.0) for v in r)


def test_augment_pitch_shift_enabled_raises():
    with pytest.raises(NotImplementedError):
        tutils.augment(torch.zeros(2, 16), {"pitch_shift": {"use": True}})
    assert tutils.augment(torch.zeros(2, 16), {"pitch_shift": {"use": False}}).shape == (2, 16)


@pytest.mark.parametrize("it,batch,rampup", [(0, 4, 10000), (7, 4, 10000),
                                             (10 ** 7, 4, 10000), (5, 4, None)])
def test_ema_rate_matches_jax(it, batch, rampup):
    assert tutils.ema_rate_at(it, batch, 0.9999, rampup) == \
        jutils.ema_rate_at(it, batch, 0.9999, rampup)


def test_ema_warmup_matches_jax():
    a, b = tutils.EMAWarmup(inv_gamma=2.0, power=0.75), jutils.EMAWarmup(inv_gamma=2.0,
                                                                          power=0.75)
    for _ in range(5):
        assert a.get_value() == b.get_value()
        a.step()
        b.step()
    c = tutils.EMAWarmup()
    c.load_state_dict(a.state_dict())
    assert c.get_value() == a.get_value()


def test_moments_and_collector_match_jax():
    x = np.random.default_rng(4).standard_normal(37).astype(np.float32)
    m = tstats.moments(_t(x)).numpy()
    np.testing.assert_allclose(m, np.asarray(jstats.moments(jnp.asarray(x))), rtol=1e-6)
    tc, jc = tstats.Collector(), jstats.Collector()
    for c in (tc, jc):
        c.update("loss", m)
        c.update("loss", m * 2)
    assert tc.mean("loss") == jc.mean("loss") and tc.std("loss") == jc.std("loss")
    tc.flush()
    assert np.isnan(tc.mean("loss")) and tc.names() == []


def test_sigma_binned_moments_match_jax():
    """Bin edges are searched side='left' in both packages: a sigma equal to
    an edge falls in the bin below it; sigmas outside the range clip to the
    end bins."""
    edges = tstats.make_sigma_bins(1e-5, 10.0, 20)
    np.testing.assert_array_equal(edges, jstats.make_sigma_bins(1e-5, 10.0, 20))
    rng = np.random.default_rng(5)
    sigma = np.exp(rng.uniform(np.log(1e-6), np.log(20.0), 64)).astype(np.float32)
    sigma[:3] = edges[[1, 7, 20]].astype(np.float32)
    loss = rng.uniform(0, 2, 64).astype(np.float32)
    ref = np.asarray(jstats.sigma_binned_moments(jnp.asarray(loss), jnp.asarray(sigma),
                                                 jnp.asarray(edges, jnp.float32)))
    got = tstats.sigma_binned_moments(_t(loss), _t(sigma)[:, None], _t(edges)).numpy()
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    bc_t, bc_j = tstats.Collector(), jstats.Collector()
    bc_t.update_binned("b", got)
    bc_j.update_binned("b", ref)
    np.testing.assert_allclose(bc_t.mean("b"), bc_j.mean("b"), rtol=1e-5)
    np.testing.assert_allclose(bc_t.std("b"), bc_j.std("b"), rtol=1e-4, atol=1e-6)


P = jedm.EDMParams()


def test_sigma_draws_follow_the_training_distribution():
    """sample_ptrain_safe maps a uniform draw through the rho_train ramp
    (the JAX function applied to the same uniform gives the same sigma);
    the log-normal draws stay inside [sigma_min, sigma_max]."""
    gen = torch.Generator().manual_seed(0)
    s = tedm.sample_ptrain_safe(tedm.EDMParams(), 4096, gen)
    assert float(s.min()) >= P.sigma_min * (1 - 1e-5) and float(s.max()) <= P.sigma_max
    a = torch.rand((4096,), generator=torch.Generator().manual_seed(0))
    lo, hi = P.sigma_min ** (1 / P.rho_train), P.sigma_max ** (1 / P.rho_train)
    torch.testing.assert_close(s, (hi + a * (lo - hi)) ** P.rho_train)
    ln = tedm.sample_ptrain_lognormal(tedm.EDMParams(), 4096, gen)
    assert float(ln.min()) >= P.sigma_min and float(ln.max()) <= P.sigma_max
    np.testing.assert_allclose(float(tedm.lambda_w(tedm.EDMParams(), torch.tensor(0.5))),
                               float(jedm.lambda_w(P, 0.5)), rtol=1e-6)


@pytest.mark.parametrize("aweight", [False, True])
def test_loss_fn_matches_jax(aweight):
    """JAX's sigma and noise (its key schedule: split into sigma and noise
    keys) are injected into the port; a fixed linear "network" keeps the
    comparison about the loss. Tolerance: f32 rounding of the
    preconditioning at small sigma, where the target is scaled by 1/c_out."""
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((4, 512)) * 0.1).astype(np.float32)
    w = rng.standard_normal(512).astype(np.float32)

    def jnet(z, cn):
        return z * jnp.asarray(w) + cn

    def tnet(z, cn):
        return z * _t(w) + cn

    key = jax.random.PRNGKey(11)
    jfilt = jutils.a_weighting_filter(22050, 101) if aweight else None
    tfilt = tutils.a_weighting_filter(22050, 101) if aweight else None
    err_j, sig_j = jedm.loss_fn(P, jnet, key, jnp.asarray(x), jfilt)
    k_sigma, k_noise = jax.random.split(key)
    sigma = np.asarray(jedm.sample_ptrain_safe(P, k_sigma, 4))
    noise = np.asarray(jedm.sample_prior(P, k_noise, x.shape, sigma[:, None]))
    err_t, sig_t = tedm.loss_fn(tedm.EDMParams(), tnet, _t(x), error_filter=tfilt,
                                sigma=_t(sigma), noise=_t(noise))
    np.testing.assert_array_equal(sig_t.numpy(), np.asarray(sig_j))
    np.testing.assert_allclose(err_t.numpy(), np.asarray(err_j), rtol=1e-4,
                               atol=1e-6 * float(np.abs(np.asarray(err_j)).max()))
