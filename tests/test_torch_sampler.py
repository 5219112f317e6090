"""The port's EDM denoiser and Heun sampler against the JAX package.

Tiny U-Net (tests/test_torch_unet.py's configuration, weights carried
across), T=4 trajectories, guided, replacement and unconditional, order 1
and 2. The JAX
sampler draws its noise from threefry keys (heun.py: prior from the first
split key, churn step i from fold_in(second key, i)); the same draws are
injected into the port. f32 on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aid_tpu.diffusion import edm as jedm
from aid_tpu.sampling import degradations as jdegr
from aid_tpu.sampling import heun as jheun
from aid_tpu.sampling.sampler import Sampler as JaxSampler
from aid_tpu.utils.config import compose as jax_compose
from aid_tpu_torch.diffusion import edm as tedm
from aid_tpu_torch.sampling import degradations as tdegr
from aid_tpu_torch.sampling import heun as theun
from aid_tpu_torch.sampling.sampler import Sampler
from aid_tpu_torch.utils.config import compose
from aid_tpu_torch.utils.convert import state_dict_from_flax
from tests.test_torch_unet import LEN, jax_model, rel_err, torch_model, trained_like
from tests.torch_threads import one_torch_thread  # noqa: F401

P = dict(sigma_data=0.063, sigma_min=1e-4, sigma_max=1.0, rho=13.0, Schurn=10.0)
T_STEPS = 4
# f32 trajectories through 7 guided score calls: the two frameworks' sum
# orders differ at f32 ulps and the guidance normalisation amplifies them
# a little per step
TRAJ_TOL = 1e-4


@pytest.fixture(scope="module")
def nets():
    p = trained_like(jax.jit(jax_model("tanh").init)(
        jax.random.PRNGKey(7), jnp.zeros((1, LEN)), jnp.zeros((1, 1))))
    net = torch_model("tanh")
    net.load_state_dict(state_dict_from_flax(p))
    net.requires_grad_(False)
    return p, net


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((1, LEN)) * 0.1).astype(np.float32)
    mask = np.ones((1, LEN), np.float32)
    mask[:, 800:1200] = 0.0
    return x * mask, mask


def _jax_noise(key, shape, T):
    k_prior, k_churn = jax.random.split(key)
    prior = np.array(jax.random.normal(k_prior, shape, jnp.float32))
    churn = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(k_churn, i), shape))
                      for i in range(T)])
    return prior, churn


def test_schedule_and_gamma_match_jax():
    jp, tp = jedm.EDMParams(**P), tedm.EDMParams(**P)
    for n in (4, 35):
        t = tedm.create_schedule(tp, n)
        tj = jedm.create_schedule(jp, n)
        np.testing.assert_allclose(t.numpy(), np.asarray(tj), rtol=1e-6, atol=0)
        np.testing.assert_allclose(tedm.get_gamma(tp, t[:-1]).numpy(),
                                   np.asarray(jedm.get_gamma(jp, tj[:-1])), rtol=1e-6)


def test_denoiser_matches_jax(nets):
    params, net = nets
    x, _ = _problem(1)
    sigma = np.array([0.3], np.float32)
    m = jax_model("tanh")
    ref = jax.jit(lambda params, x, s: jedm.denoiser(
        jedm.EDMParams(**P), lambda a, c: m.apply(params, a, c), x, s))(
            params, jnp.asarray(x), jnp.asarray(sigma))
    with torch.no_grad():
        got = tedm.denoiser(tedm.EDMParams(**P), net, torch.from_numpy(x),
                            torch.from_numpy(sigma))
    assert rel_err(got.numpy(), ref) < 1e-5


@pytest.mark.parametrize("mode", ["guided", "replacement", "unconditional"])
@pytest.mark.parametrize("order", [1, 2])
def test_trajectory_matches_jax(nets, mode, order):
    params, net = nets
    y, mask = _problem(2)
    smooth = tdegr.make_smooth_mask(mask, 50)
    xi = 0.25 if mode == "guided" else 0.0
    cond = mode != "unconditional"
    m = jax_model("tanh")
    jp, tp = jedm.EDMParams(**P), tedm.EDMParams(**P)
    cqt_j = m.cqt

    def run_jax(params, key):
        def denoise(x, t):
            sig = jnp.broadcast_to(jnp.asarray(t, jnp.float32), (x.shape[0], 1))
            return jedm.denoiser(jp, lambda a, c: m.apply(params, a, c), x, sig)
        cfg = jheun.SamplerConfig(T=T_STEPS, order=order, xi=xi)
        proj = jdegr.inpainting_projector(jnp.asarray(y), jnp.asarray(smooth))
        if not cond:
            score = jheun.make_score_fn(jp, cfg, denoise, hpf=cqt_j.apply_hpf_DC)
            return jheun.heun_sample(key, y.shape, jp, cfg, score)[0]
        score = jheun.make_score_fn(jp, cfg, denoise, y=jnp.asarray(y),
                                    degradation=jdegr.time_mask(jnp.asarray(mask)),
                                    proj=proj, hpf=cqt_j.apply_hpf_DC)
        return jheun.heun_sample(key, y.shape, jp, cfg, score, proj_end=proj)[0]

    key = jax.random.PRNGKey(11)
    ref = np.asarray(jax.jit(run_jax)(params, key))
    prior, churn = _jax_noise(key, y.shape, T_STEPS)

    def denoise(x, t):
        return tedm.denoiser(tp, net, x, t.reshape(1, 1).expand(x.shape[0], 1))

    cfg = theun.SamplerConfig(T=T_STEPS, order=order, xi=xi)
    yt, mt = torch.from_numpy(y), torch.from_numpy(mask)
    proj = tdegr.inpainting_projector(yt, torch.from_numpy(smooth)) if cond else None
    score = (theun.make_score_fn(tp, cfg, denoise, y=yt, degradation=tdegr.time_mask(mt),
                                 proj=proj, hpf=net.cqt.apply_hpf_DC) if cond
             else theun.make_score_fn(tp, cfg, denoise, hpf=net.cqt.apply_hpf_DC))
    got = theun.heun_sample(y.shape, tp, cfg, score, proj_end=proj,
                            prior=torch.from_numpy(prior), churn=torch.from_numpy(churn))
    assert np.isfinite(ref).all()
    err = rel_err(got.numpy(), ref)
    assert err < TRAJ_TOL, err


def test_sampler_config_matches_jax():
    """The tester's diff_params override (same_as_training: False) and the
    sampler options come out as in the JAX package's Sampler."""
    args, jargs = compose(), jax_compose()
    s = Sampler(torch.nn.Linear(1, 1), tedm.EDM(args), args)
    js = JaxSampler(None, jedm.EDM(jargs), jargs)
    assert s.p.__dict__ == js.p.__dict__
    assert (s.p.sigma_max, s.p.sigma_min, s.p.Schurn) == (1.0, 1e-4, 10.0)
    for f in ("T", "order", "xi", "norm", "data_consistency", "data_consistency_end",
              "filter_out_cqt_DC_Nyq", "guidance_eps"):
        assert getattr(s.cfg, f) == getattr(js.cfg, f), f
    assert (s.smooth, s.hann_size) == (js.smooth, js.hann_size)


def test_smooth_mask_rows_match_jax_rows():
    """Each row is smoothed on its own; a row equals the JAX package's
    smoothing of that row alone (the JAX package broadcasts row 0)."""
    mask = np.ones((2, 1000), np.float32)
    mask[0, 100:200] = 0.0
    mask[1, 600:700] = 0.0
    mask[1, 10:30] = 0.0
    got = tdegr.make_smooth_mask(mask, 50)
    for r in range(2):
        np.testing.assert_array_equal(got[r], jdegr.make_smooth_mask(mask[r], 50))


@pytest.mark.parametrize("norm", [1, 2, "smoothl1"])
def test_residual_norm_matches_jax(norm):
    r = np.random.default_rng(3).standard_normal((3, 50)).astype(np.float32) * 2
    got = theun._residual_norm(theun.SamplerConfig(norm=norm), torch.from_numpy(r))
    ref = jheun._residual_norm(jheun.SamplerConfig(norm=norm), jnp.asarray(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("placement", ["inpainting", "generic"])
def test_guidance_eps_placement_matches_jax(nets, placement):
    """One guided score with each epsilon placement."""
    params, net = nets
    y, mask = _problem(4)
    x = (np.random.default_rng(5).standard_normal(y.shape) * 0.5).astype(np.float32)
    t = np.float32(0.5)
    m = jax_model("tanh")
    jp, tp = jedm.EDMParams(**P), tedm.EDMParams(**P)

    def jscore(params, x):
        def denoise(x, t):
            sig = jnp.broadcast_to(jnp.asarray(t, jnp.float32), (x.shape[0], 1))
            return jedm.denoiser(jp, lambda a, c: m.apply(params, a, c), x, sig)
        cfg = jheun.SamplerConfig(guidance_eps=placement)
        return jheun.make_score_fn(jp, cfg, denoise, y=jnp.asarray(y),
                                   degradation=jdegr.time_mask(jnp.asarray(mask)),
                                   proj=jdegr.inpainting_projector(jnp.asarray(y),
                                                                  jnp.asarray(mask)),
                                   hpf=m.cqt.apply_hpf_DC)(x, t)[0]

    ref = np.asarray(jax.jit(jscore)(params, jnp.asarray(x)))
    cfg = theun.SamplerConfig(guidance_eps=placement)
    yt, mt = torch.from_numpy(y), torch.from_numpy(mask)
    score = theun.make_score_fn(
        tp, cfg, lambda a, s: tedm.denoiser(tp, net, a, s.reshape(1, 1)),
        y=yt, degradation=tdegr.time_mask(mt), proj=tdegr.inpainting_projector(yt, mt),
        hpf=net.cqt.apply_hpf_DC)
    got = score(torch.from_numpy(x), torch.tensor(t))
    assert rel_err(got.numpy(), ref) < 1e-5


def test_heun_sample_without_device_or_prior_needs_cuda(monkeypatch):
    """No device and no prior means CUDA: without a card it raises rather
    than drawing the noise on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        theun.heun_sample((1, 8), tedm.EDMParams(), theun.SamplerConfig(T=3),
                          lambda x, t: x)


def test_heun_sample_rejects_wrong_noise_shapes():
    cfg = theun.SamplerConfig(T=3)
    with pytest.raises(ValueError):
        theun.heun_sample((1, 8), tedm.EDMParams(), cfg, lambda x, t: x,
                          prior=torch.zeros(1, 8), churn=torch.zeros(2, 1, 8))
