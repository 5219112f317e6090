"""The port's sampler tasks against the JAX package's ``Sampler.predict_*``.

The denoiser network is a small nonlinear stand-in with the tiny CQT's
band-limit filter (tests/test_torch_unet.py's 3-octave design), the same
function in both packages: the U-Net's own parity is held in
test_torch_unet.py and test_torch_sampler.py, and a stand-in keeps the JAX
package's per-task compilation short; spectrogram inpainting also runs on
the tiny U-Net itself. T=3, order 2, f32 on the CPU. The
JAX sampler draws its noise from threefry keys; the same draws are
recomputed from its key schedule and injected into the port. Each task's
full trajectory, and the ``rid`` Record field by field, must agree to
``TRAJ_TOL``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aid_tpu.diffusion import edm as jedm
from aid_tpu.models.bundle import NetBundle
from aid_tpu.ops.cqt import get_cqt as jax_get_cqt
from aid_tpu.sampling import degradations as jdegr
from aid_tpu.sampling.sampler import Sampler as JaxSampler
from aid_tpu.utils.config import compose as jax_compose
from aid_tpu_torch.diffusion import edm as tedm
from aid_tpu_torch.ops.cqt import get_cqt
from aid_tpu_torch.sampling import degradations as tdegr
from aid_tpu_torch.sampling.sampler import Sampler
from aid_tpu_torch.utils.config import compose
from tests.test_torch_sampler import TRAJ_TOL, _jax_noise
from tests.test_torch_unet import BINS, FS, LEN, O, rel_err
from tests.torch_threads import one_torch_thread  # noqa: F401

T_STEPS = 3
OVERRIDES = [f"exp.audio_len={LEN}", f"exp.sample_rate={int(FS)}", f"tester.T={T_STEPS}",
             "tester.order=2", "tester.spectrogram_inpainting.stft.n_fft=256",
             "tester.spectrogram_inpainting.stft.hop_length=64",
             "tester.spectrogram_inpainting.stft.win_length=256"]


class JaxStandIn:
    """apply(params, x, cnoise) = 0.8 tanh(w x) + 0.05 cnoise, with a CQT."""

    def __init__(self):
        self.cqt = jax_get_cqt(O, BINS, FS, LEN)

    def apply(self, params, x, cn):
        return 0.8 * jnp.tanh(params["w"] * x) + 0.05 * cn


class TorchStandIn(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.cqt = get_cqt(O, BINS, FS, LEN)
        self.w = torch.nn.Parameter(torch.tensor(1.5), requires_grad=False)

    def forward(self, x, cn):
        return 0.8 * torch.tanh(self.w * x) + 0.05 * cn


@pytest.fixture(scope="module")
def nets():
    return JaxStandIn(), TorchStandIn()


def _samplers(nets, rid=False):
    jnet, tnet = nets
    jargs, targs = jax_compose(overrides=OVERRIDES), compose(overrides=OVERRIDES)
    js = JaxSampler(NetBundle(jnet, {"w": jnp.float32(1.5)}), jedm.EDM(jargs), jargs, rid=rid)
    return js, Sampler(tnet, tedm.EDM(targs), targs, rid=rid)


def _signal(seed=0, batch=1):
    rng = np.random.default_rng(seed)
    t = np.arange(LEN) / FS
    x = 0.1 * np.sin(2 * np.pi * 220 * t) + 0.03 * rng.standard_normal((batch, LEN))
    return x.astype(np.float32)


def _noise(key, shape):
    prior, churn = _jax_noise(key, shape, T_STEPS)
    return dict(prior=torch.from_numpy(prior), churn=torch.from_numpy(churn))


def _spectral_mask(stft_cfg):
    F = int(stft_cfg.n_fft) // 2 + 1
    frames = 1 + (LEN + int(stft_cfg.n_fft) - LEN % int(stft_cfg.n_fft)) // int(
        stft_cfg.hop_length)
    m = np.ones((F, frames), np.float32)
    m[10:40, 12:24] = 0.0
    return m


def _run_task(js, ts, task, key):
    """(JAX output, port output) of one task on the same inputs and noise."""
    x = _signal(1)
    stft_cfg = ts.args.tester.spectrogram_inpainting.stft
    if task == "spectrogram_inpainting":
        m = _spectral_mask(stft_cfg)
        y = np.array(jdegr.spectral_mask(jnp.asarray(m), stft_cfg)(jnp.asarray(x)))
        ref = js.predict_spectrogram_inpainting(jnp.asarray(y), jnp.asarray(m), key)
        got = ts.predict_spectrogram_inpainting(torch.from_numpy(y), torch.from_numpy(m),
                                                **_noise(key, y.shape))
    elif task.startswith("bwe"):
        kind = task.split("_")[1]
        order = 4 if kind == "cheby1" else 64
        fc = FS / 8 if kind == "decimate" else 400.0     # decimation by 4
        lpf = tdegr.bwe_lowpass(kind, order, fc, FS)
        y = lpf(torch.from_numpy(x)).numpy()       # the same lowpassed observation
        ref = js.predict_bwe(jnp.asarray(y), key, fc, FS, filter_type=kind, order=order)
        got = ts.predict_bwe(torch.from_numpy(y), fc, FS, filter_type=kind, order=order,
                             **_noise(key, y.shape))
    elif task == "declipping":
        cv = float(jdegr.clip_value_from_sdr(jnp.asarray(x), 3.0))
        y = np.clip(x, -cv, cv)
        ref = js.predict_declipping(jnp.asarray(y), key, cv)
        got = ts.predict_declipping(torch.from_numpy(y), cv, **_noise(key, y.shape))
    elif task == "phase_retrieval":
        y = np.array(jdegr.stft_magnitude(stft_cfg)(jnp.asarray(x)))
        ref = js.predict_phase_retrieval(jnp.asarray(y), x.shape, key)
        got = ts.predict_phase_retrieval(torch.from_numpy(y), x.shape, **_noise(key, x.shape))
    elif task == "compsens":
        m = np.array(jdegr.compsens_mask(jax.random.PRNGKey(3), x.shape, 20.0))
        ref = js.predict_compsens(jnp.asarray(x * m), jnp.asarray(m), key)
        got = ts.predict_compsens(torch.from_numpy(x * m), torch.from_numpy(m),
                                  **_noise(key, x.shape))
    else:   # autoregressive, 3 segments: one key split off per segment
        ref = js.predict_autoregressive(key, 3, overlap=0.25, shape=(1, LEN))
        k, keys = key, []
        for _ in range(3):
            k, sub = jax.random.split(k)
            keys.append(sub)
        noise = [_noise(s, (1, LEN)) for s in keys]
        got = ts.predict_autoregressive(3, 0.25, shape=(1, LEN),
                                        priors=[n["prior"] for n in noise],
                                        churns=[n["churn"] for n in noise])
    return np.asarray(ref), got.numpy()


TASKS = ["spectrogram_inpainting", "bwe_firwin", "bwe_cheby1", "bwe_butter",
         "bwe_decimate", "declipping", "phase_retrieval", "compsens", "autoregressive"]


@pytest.mark.parametrize("task", TASKS)
def test_task_trajectory_matches_jax(nets, task):
    ref, got = _run_task(*_samplers(nets), task, jax.random.PRNGKey(11))
    length = LEN + 2 * (LEN - LEN // 4) if task == "autoregressive" else LEN
    assert ref.shape == got.shape == (1, length) and np.isfinite(ref).all()
    err = rel_err(got, ref)
    assert err < TRAJ_TOL, err


def test_rid_record_matches_jax(nets):
    """Guided inpainting with ``rid``: every Record field, [T, B, L]."""
    js, ts = _samplers(nets, rid=True)
    x = _signal(4)
    mask = np.ones_like(x)
    mask[:, 900:1300] = 0.0
    key = jax.random.PRNGKey(5)
    ref_x, ref = js.predict_inpainting(jnp.asarray(x * mask), jnp.asarray(mask), key)
    got_x, got = ts.predict_inpainting(torch.from_numpy(x * mask), torch.from_numpy(mask),
                                       **_noise(key, x.shape))
    assert rel_err(got_x.numpy(), ref_x) < TRAJ_TOL
    assert got._fields == ref._fields
    for field in ref._fields:
        r, g = np.asarray(getattr(ref, field)), getattr(got, field).numpy()
        assert g.shape == r.shape == (T_STEPS, 1, LEN), field
        assert rel_err(g, r) < TRAJ_TOL, (field, rel_err(g, r))


# ------------------------------------------------------------ degradations

def test_firwin_decimate_clip_match_jax():
    """FIR lowpass, decimate / zero-stuff, hard clip and the SDR clip level,
    to 1e-5 relative."""
    x = _signal(6, batch=2)
    for order, fc in ((64, 400.0), (200, 1000.0)):
        ref = np.asarray(jdegr.firwin_lowpass(order, fc, FS)(jnp.asarray(x)))
        got = tdegr.firwin_lowpass(order, fc, FS)(torch.from_numpy(x)).numpy()
        assert rel_err(got, ref) < 1e-5
    jdown, jup = jdegr.decimate(4)
    tdown, tup = tdegr.decimate(4)
    np.testing.assert_array_equal(tup(tdown(torch.from_numpy(x))).numpy(),
                                  np.asarray(jup(jdown(jnp.asarray(x)))))
    for sdr in (1.0, 3.0, 10.0):
        cv = float(tdegr.clip_value_from_sdr(torch.from_numpy(x), sdr))
        ref = float(jdegr.clip_value_from_sdr(jnp.asarray(x), sdr))
        assert abs(cv - ref) <= 1e-5 * ref, (sdr, cv, ref)
        np.testing.assert_array_equal(tdegr.hard_clip(cv)(torch.from_numpy(x)).numpy(),
                                      np.asarray(jdegr.hard_clip(cv)(jnp.asarray(x))))


@pytest.mark.parametrize("kind,order", [("butter", 2), ("cheby1", 2), ("cheby1", 4)])
def test_iir_fft_form_matches_jax_scan(kind, order):
    """The FFT form of the IIR lowpass against the JAX package's lax.scan
    recursion, to 1e-4 relative (the recursion runs with f32 coefficients,
    the impulse response with f64 ones)."""
    x = _signal(7, batch=2)
    ref = np.asarray(jdegr.iir_lowpass(kind, order, 400.0, FS)(jnp.asarray(x)))
    got = tdegr.iir_lowpass(kind, order, 400.0, FS)(torch.from_numpy(x)).numpy()
    assert rel_err(got, ref) < 1e-4


def test_unstable_cheby1_raises():
    """The configured cheby1 order 200 has poles far outside the unit circle
    (its recursion in the JAX package diverges); low orders are stable."""
    x = jnp.asarray(_signal(8))
    assert not np.isfinite(np.asarray(jdegr.iir_lowpass("cheby1", 200, 1000.0, 22050.0)(x))).all()
    with pytest.raises(ValueError, match="order 200.*pole radius"):
        tdegr.iir_lowpass("cheby1", 200, 1000.0, 22050.0)
    tdegr.iir_lowpass("cheby1", 4, 1000.0, 22050.0)


def test_compsens_mask_keeps_its_share():
    gen = torch.Generator().manual_seed(0)
    m = tdegr.compsens_mask((4, 20000), 5.0, generator=gen)
    assert set(np.unique(m.numpy())) <= {0.0, 1.0}
    assert abs(float(m.mean()) - 0.05) < 0.005


def test_spectrogram_inpainting_through_the_unet_matches_jax():
    """One task on the tiny U-Net itself (weights carried across): guidance
    through the STFT mask and the denoiser's backward together."""
    from aid_tpu_torch.utils.convert import state_dict_from_flax
    from tests.test_torch_unet import jax_model, torch_model, trained_like
    params = trained_like(jax.jit(jax_model("tanh").init)(
        jax.random.PRNGKey(7), jnp.zeros((1, LEN)), jnp.zeros((1, 1))))
    net = torch_model("tanh")
    net.load_state_dict(state_dict_from_flax(params))
    net.requires_grad_(False)
    jargs, targs = jax_compose(overrides=OVERRIDES), compose(overrides=OVERRIDES)
    js = JaxSampler(NetBundle(jax_model("tanh"), params), jedm.EDM(jargs), jargs)
    ref, got = _run_task(js, Sampler(net, tedm.EDM(targs), targs), "spectrogram_inpainting",
                         jax.random.PRNGKey(13))
    assert np.isfinite(ref).all() and rel_err(got, ref) < TRAJ_TOL, rel_err(got, ref)
