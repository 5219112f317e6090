"""The port's evaluation path against the JAX package's ``Tester``: masks,
the file tree of every mode, a reconstruction, checkpoint loading and the
``python -m aid_tpu_torch.test`` entry.

Tiny configuration (3 octaves, 8 bins, 2048 samples at 4096 Hz,
Ns=(8,16,16)), f32 on the CPU; JAX weights are carried across with
``state_dict_from_flax`` or through a reference-layout ``.pt`` written by
the JAX package's ``export_checkpoint``. The JAX tester's noise is
recomputed from its key schedule and injected into the port in call order.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aid_tpu import setup as asetup
from aid_tpu.diffusion import edm as jedm
from aid_tpu.utils import ckpt_io as jckpt_io
from aid_tpu.utils.checkpoint_torch import export_checkpoint, export_state_dict
from aid_tpu.utils.config import compose as jax_compose
from aid_tpu_torch import setup as tsetup
from aid_tpu_torch import test as ttest
from aid_tpu_torch.data import audio_io
from aid_tpu_torch.diffusion import edm as tedm
from aid_tpu_torch.sampling import degradations as tdegr
from aid_tpu_torch.utils import checkpoint_torch
from aid_tpu_torch.utils.config import compose
from aid_tpu_torch.utils.convert import state_dict_from_flax
from tests.test_torch_sampler import TRAJ_TOL, _jax_noise
from tests.test_torch_unet import rel_err, trained_like
from tests.torch_threads import one_torch_thread  # noqa: F401

L, FS = 2048, 4096
TINY = ["network.cqt.num_octs=3", "network.cqt.bins_per_oct=8", f"exp.audio_len={L}",
        f"exp.sample_rate={FS}", "network.Ns=[8,16,16]", "network.num_dils=[1,2,2]",
        "network.attention_layers=[0,1,1,1]", "network.emb_dim=32",
        "network.attention_dict.num_heads=2", "network.compute_dtype=float32", "tester.T=3",
        "tester.unconditional.num_samples=1", f"tester.unconditional.audio_len={L}",
        "tester.autoregressive.num_samples=2", "+tester.inpainting.mushra_gap_lengths=[50,100]",
        "tester.inpainting.long.gap_length=100",
        "tester.spectrogram_inpainting.time_mask_length=100"]
MODES = ["unconditional", "inpainting", "inpainting_mushra", "inpainting_shortgaps",
         "spectrogram_inpainting", "bwe", "declipping", "comp_sens", "phase_retrieval",
         "autoregressive"]
LSB = 1.0 / 32767          # one step of the 16-bit wav files


class SynthTestSet:
    """(audio, fs, filename) items: a tone plus noise."""

    def __init__(self, n=2):
        rng = np.random.default_rng(0)
        t = np.arange(L) / FS
        self.items = [((0.1 * np.sin(2 * np.pi * (200 + 50 * i) * t)
                        + 0.02 * rng.standard_normal(L)).astype(np.float32), FS, f"clip_{i}.wav")
                      for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __iter__(self):
        return iter(self.items)


def _jax_tester(tmp, params, extra=(), test_set=None):
    args = jax_compose(overrides=TINY + list(extra) + [f"model_dir={tmp}/jax"])
    bundle = asetup.setup_network(args)
    bundle.params = params
    return asetup.setup_tester(args, network=bundle, diff_params=asetup.setup_diff_parameters(
        args), test_set=test_set or SynthTestSet())


def _port_tester(tmp, extra=(), state_dict=None, test_set=None):
    args = compose(overrides=TINY + list(extra) + [f"model_dir={tmp}/torch"])
    net = tsetup.setup_network(args, device="cpu", state_dict=state_dict, seed=0)
    return tsetup.setup_tester(args, network=net, diff_params=tsetup.setup_diff_parameters(args),
                               test_set=test_set or SynthTestSet(), device="cpu")


@pytest.fixture(scope="module")
def jax_params():
    args = jax_compose(overrides=TINY)
    bundle = asetup.setup_network(args)
    return trained_like(bundle.init(jax.random.PRNGKey(3), 1, L))


# ------------------------------------------------------------------ masks

MASK_CASES = {
    "long_centred": ([], ("long", None)),
    "long_start": (["tester.inpainting.long.start_gap_idx=120"], ("long", None)),
    "short_starts": (["tester.inpainting.short.start_gap_idx=[20,120,220,320]"],
                     ("short", None)),
    "short_random": ([], ("short", 7)),
    "spectral_centred": ([], "spectral"),
    "spectral_start": (["tester.spectrogram_inpainting.time_start_idx=150"], "spectral"),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_masks_match_jax(tmp_path, jax_params, case):
    """Exactly the JAX tester's masks; a random short-gap mask from the seed
    the JAX tester takes out of its key."""
    extra, what = MASK_CASES[case]
    jt, pt = _jax_tester(tmp_path, jax_params, extra), _port_tester(tmp_path, extra)
    if what == "spectral":
        ref, got = jt.prepare_spectral_mask(), pt.prepare_spectral_mask()
    else:
        mode, seed = what
        key = None if seed is None else jax.random.PRNGKey(seed)
        ref = jt.prepare_mask(mode, key)
        got = pt.prepare_mask(mode, None if key is None else
                              int(np.asarray(jax.random.key_data(key))[-1]))
    assert (ref == 0).any()
    np.testing.assert_array_equal(got, ref)


# --------------------------------------------------------------- file tree

class StubJaxSampler:
    """Instant stand-ins for the JAX sampler's tasks: the JAX tester's own
    file writing and metrics run without compiling a sampler."""

    def predict_unconditional(self, shape, key):
        return jnp.zeros(shape)

    def predict_inpainting(self, y, mask, key):
        return y

    def predict_spectrogram_inpainting(self, y, mask, key):
        return y

    def predict_bwe(self, y, key, fc, fs, filter_type="firwin", order=200):
        return y

    def predict_declipping(self, y, key, cv):
        return y

    def predict_compsens(self, y, mask, key):
        return y

    def predict_phase_retrieval(self, y_mag, shape, key):
        return jnp.zeros(shape)

    def predict_autoregressive(self, key, n, overlap):
        return np.zeros((1, L + (n - 1) * (L - int(L * overlap))), np.float32)


def _tree(base):
    return sorted(os.path.relpath(os.path.join(root, f), base)
                  for root, _, files in os.walk(base) for f in files)


def test_dodajob_writes_the_jax_file_tree(tmp_path, jax_params):
    """All ten modes: the port (tiny net, T=2) writes the same files as the
    JAX tester, every wav finite, metrics.json with finite LSD and SNR."""
    extra = ["tester.T=2", f"tester.modes={MODES}".replace(" ", "")]
    jt = _jax_tester(tmp_path, jax_params, extra)
    jt.sampler = StubJaxSampler()
    jt.dodajob()
    pt = _port_tester(tmp_path, extra)
    results = pt.dodajob()
    assert list(results) == MODES and set(pt.seconds) == set(MODES)
    ref, got = _tree(jt.base_dir), _tree(pt.base_dir)
    assert got == ref
    assert sum(f.endswith(".wav") for f in got) == 54
    for f in got:
        path = os.path.join(pt.base_dir, f)
        if f.endswith(".wav"):
            assert np.isfinite(audio_io.read(path)[0]).all(), f
        elif f.endswith("metrics.json"):
            mean = json.load(open(path))["__mean__"]
            assert np.isfinite(mean["lsd"]) and np.isfinite(mean["snr"]), f


def test_inpainting_matches_jax_tester(tmp_path, jax_params):
    """test_inpainting on two files, batch 1: the reconstructions the two
    testers save agree to TRAJ_TOL (and their wav files to one 16-bit step
    more), with the JAX tester's noise injected in call order."""
    jt = _jax_tester(tmp_path, jax_params)
    pt = _port_tester(tmp_path, state_dict=state_dict_from_flax(jax_params))
    saved = {"jax": {}, "torch": {}}
    for name, t in (("jax", jt), ("torch", pt)):
        def spy(mode, fname, original, degraded, reconstructed, _save=t._save_triplet,
                _into=saved[name]):
            _into[fname] = np.asarray(reconstructed)
            _save(mode, fname, original, degraded, reconstructed)
        t._save_triplet = spy
    key, noise = jt.key, []
    for _ in range(2):
        key, k = jax.random.split(key)
        noise.append(_jax_noise(k, (1, L), int(jt.t.T)))
    predict = pt.sampler.predict_inpainting

    def injected(y, mask, generator=None):
        prior, churn = noise.pop(0)
        return predict(y, mask, prior=torch.from_numpy(prior), churn=torch.from_numpy(churn))

    pt.sampler.predict_inpainting = injected
    assert jt.test_inpainting() == pt.test_inpainting() == ["clip_0", "clip_1"]
    for f in ("clip_0", "clip_1"):
        ref, got = saved["jax"][f], saved["torch"][f]
        assert np.isfinite(ref).all() and rel_err(got, ref) < TRAJ_TOL, rel_err(got, ref)
        wr = audio_io.read(os.path.join(jt.base_dir, "inpainting", "reconstructed", f + ".wav"))
        wg = audio_io.read(os.path.join(pt.base_dir, "inpainting", "reconstructed", f + ".wav"))
        assert np.abs(wg[0] - wr[0]).max() <= TRAJ_TOL * np.abs(wr[0]).max() + LSB


def test_bwe_feeds_the_lowpassed_observation(tmp_path, jax_params):
    """The port's test_bwe guides with, and saves as "degraded", the
    lowpass of the audio by the filter predict_bwe uses (here cheby1 of
    order 4); the JAX tester feeds the clean audio."""
    extra = ["tester.bandwidth_extension.filter.type=cheby1",
             "tester.bandwidth_extension.filter.order=4"]
    jt, pt = _jax_tester(tmp_path, jax_params, extra), _port_tester(tmp_path, extra)
    fed = {}
    jt.sampler = StubJaxSampler()
    jt.sampler.predict_bwe = lambda y, key, *a, **k: fed.setdefault("jax", np.asarray(y))
    pt.sampler.predict_bwe = lambda y, *a, **k: fed.setdefault("torch", y)
    audio = np.stack([item[0] for item in SynthTestSet(1)])
    pt.test_set = jt.test_set = SynthTestSet(1)
    jt.test_bwe()
    pt.test_bwe()
    lowpassed = tdegr.bwe_lowpass("cheby1", 4, 1000.0, FS)(torch.from_numpy(audio))
    np.testing.assert_array_equal(fed["torch"].numpy(), lowpassed.numpy())
    np.testing.assert_array_equal(fed["jax"], audio)
    saved = audio_io.read(os.path.join(pt.base_dir, "bwe", "degraded", "clip_0.wav"))[0]
    # 16-bit files: truncation to the step, plus the 32767 / 32768 scale
    assert np.abs(saved - lowpassed.numpy()[0]).max() <= 2 * LSB


def test_interactive_spectrogram_inpainting(tmp_path):
    """The notebook call: one segment at another rate under a painted STFT
    mask comes back at the model's length and rate; the observation it
    guides with is the masked segment as the JAX package resamples it
    (libsoxr in both), exactly."""
    from aid_tpu.data import audio_io as jaudio
    pt = _port_tester(tmp_path, ["tester.T=2"])
    seg = np.repeat(SynthTestSet(1).items[0][0], 2)          # at 2 FS
    mask = pt.prepare_spectral_mask()
    fed = []
    predict = pt.sampler.predict_spectrogram_inpainting

    def spy(y, m, **k):
        fed.append(y.clone())
        return predict(y, m, **k)

    pt.sampler.predict_spectrogram_inpainting = spy
    out = pt.interactive_spectrogram_inpainting(seg, 2 * FS, mask)
    assert out.shape == (L,) and np.isfinite(out).all()
    ref = np.pad(jaudio.resample_host(seg, 2 * FS, FS), (0, L))[:L]
    want = tdegr.spectral_mask(torch.from_numpy(mask), pt.t.spectrogram_inpainting.stft)(
        torch.from_numpy(ref)[None])
    np.testing.assert_array_equal(fed[0].numpy(), want.numpy())


def test_cheby1_of_the_configured_order_raises(tmp_path):
    """The configured ``order: 200`` cheby1 is unstable: the tester raises
    before sampling."""
    pt = _port_tester(tmp_path, ["tester.bandwidth_extension.filter.type=cheby1"])
    with pytest.raises(ValueError, match="unstable"):
        pt.test_bwe()


# ------------------------------------------------------------- checkpoints

def _payload(kind, sd):
    """One of the reference checkpoint layouts around state dict ``sd``."""
    if kind in ("ema", "network", "state_dict"):
        return {"it": 9, kind: sd, "optimizer": {}}
    if kind == "model_ema_weights":
        return {"model": {k: torch.zeros(1) for k in sd}, "ema_weights": list(sd.values())}
    return {"diffusion." + k: v for k, v in sd.items()}


@pytest.mark.parametrize("kind", ["ema", "network", "state_dict", "model_ema_weights",
                                  "bare_prefixed"])
def test_pt_locate(tmp_path, jax_params, kind):
    """Each payload layout loads, through Tester.load_checkpoint, exactly
    the weights state_dict_from_flax gives for the same parameters."""
    ref = state_dict_from_flax(jax_params)
    sd = {k: torch.from_numpy(v.copy()) for k, v in export_state_dict(jax_params).items()}
    path = str(tmp_path / f"{kind}.pt")
    torch.save(_payload(kind, sd), path)
    pt = _port_tester(tmp_path)
    assert pt.load_checkpoint(path)
    got = pt.network.state_dict()
    assert set(got) == set(ref)
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0, msg=k)


def test_exported_checkpoint_loads_and_denoises_as_jax(tmp_path, jax_params):
    """A .pt from the JAX export_checkpoint (EMA distinct from the network
    weights): the port loads the EMA, and its denoiser then matches JAX's
    with those weights. A JAX stream .ckpt loads to the same weights, and
    the latest-checkpoint scan takes the highest iteration."""
    ema = jax.tree_util.tree_map(lambda v: v * 1.01, jax_params)
    jt = _jax_tester(tmp_path, jax_params)
    path = export_checkpoint(str(tmp_path / "ref-100.pt"), jt.bundle, it=100, ema_params=ema)
    pt = _port_tester(tmp_path)
    assert pt.load_checkpoint(path)
    ref_sd = state_dict_from_flax(ema)
    for k, v in pt.network.state_dict().items():
        torch.testing.assert_close(v, ref_sd[k], rtol=0, atol=0, msg=k)

    x = (np.random.default_rng(1).standard_normal((1, L)) * 0.1).astype(np.float32)
    sigma = np.array([0.2], np.float32)
    m, jp = jt.bundle.module, jt.sampler.p
    ref = jax.jit(lambda p, a, s: jedm.denoiser(jp, lambda u, c: m.apply(p, u, c), a, s))(
        ema, jnp.asarray(x), jnp.asarray(sigma))
    with torch.no_grad():
        got = tedm.denoiser(pt.sampler.p, pt.network, torch.from_numpy(x),
                            torch.from_numpy(sigma))
    assert rel_err(got.numpy(), np.asarray(ref)) < 1e-5

    jckpt_io.save_stream(str(tmp_path / "run-300.ckpt"),
                         {"it": 300, "network": jax_params, "ema": jax_params})
    assert pt.load_latest_checkpoint(str(tmp_path))
    ref_sd = state_dict_from_flax(jax_params)
    for k, v in pt.network.state_dict().items():
        torch.testing.assert_close(v, ref_sd[k], rtol=0, atol=0, msg=k)


def test_checkpoint_that_does_not_fit_raises(tmp_path, jax_params):
    sd = {k: torch.from_numpy(v.copy()) for k, v in export_state_dict(jax_params).items()}
    sd.pop(sorted(sd)[0])
    sd["extra.weight"] = torch.zeros(1)
    torch.save({"ema": sd}, str(tmp_path / "bad.pt"))
    pt = _port_tester(tmp_path)
    before = {k: v.clone() for k, v in pt.network.state_dict().items()}
    with pytest.raises(KeyError, match="1 missing.*1 unexpected"):
        pt.load_checkpoint(str(tmp_path / "bad.pt"))
    for k, v in pt.network.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert not pt.load_checkpoint() and not pt.load_latest_checkpoint(str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError):
        pt.load_checkpoint(str(tmp_path / "missing.pt"))


def test_bf16_network_takes_the_checkpoint_in_its_dtypes(tmp_path, jax_params):
    """The serving network stores conv and linear weights in bf16: loading
    casts each tensor to the dtype it is stored in."""
    path = str(tmp_path / "w.pt")
    torch.save({"ema": state_dict_from_flax(jax_params)}, path)
    args = compose(overrides=TINY + ["network.compute_dtype=bfloat16"])
    net = tsetup.setup_network(args, device="cpu")
    dtypes = {k: v.dtype for k, v in net.state_dict().items()}
    assert torch.bfloat16 in dtypes.values()
    checkpoint_torch.load_reference_checkpoint(path, net)
    assert {k: v.dtype for k, v in net.state_dict().items()} == dtypes


# -------------------------------------------------------------- entry point

@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    for i, (x, fs, name) in enumerate(SynthTestSet(2)):
        # one file at twice the model's rate: the tester resamples it
        audio_io.write(str(d / name), np.repeat(x, 2) if i else x, 2 * fs if i else fs)
    return str(d)


def test_test_entry_end_to_end(wav_dir, tmp_path, jax_params, capsys):
    """python -m aid_tpu_torch.test on the CPU over a wav folder: the
    explicit checkpoint is loaded, two modes run, their trees and metrics
    are written."""
    ckpt = str(tmp_path / "w.pt")
    torch.save({"ema": state_dict_from_flax(jax_params)}, ckpt)
    md = str(tmp_path / "run")
    assert ttest.main(TINY + ["dset=musicnet", f"dset.path={wav_dir}",
                              f"dset.test.path={wav_dir}", "tester.T=2",
                              "tester.modes=['inpainting','unconditional']",
                              f"tester.checkpoint={ckpt}", f"model_dir={md}"],
                      device="cpu") == 0
    out = capsys.readouterr().out
    assert "WARNING" not in out and "inpainting: 2 ->" in out
    base = os.path.join(md, "test")
    tree = _tree(base)
    assert sum(f.endswith(".wav") for f in tree) == 7
    assert sum(f.endswith("metrics.json") for f in tree) == 1


def test_test_entry_without_checkpoint_warns(wav_dir, tmp_path, capsys):
    assert ttest.main(TINY + ["dset=musicnet", f"dset.path={wav_dir}",
                              f"dset.test.path={wav_dir}", "tester.T=2",
                              "tester.modes=['unconditional']", f"model_dir={tmp_path}"],
                      device="cpu") == 0
    assert "WARNING: no checkpoint found" in capsys.readouterr().out


def test_without_cuda_the_evaluation_path_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttest.main(TINY + [f"model_dir={tmp_path}"])
    args = compose(overrides=TINY + ["tester.do_test=False"])
    net = tsetup.setup_network(args, device="cpu")
    diff = tsetup.setup_diff_parameters(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsetup.setup_tester(args, network=net, diff_params=diff)
    from aid_tpu_torch.testing.tester import Tester
    with pytest.raises(RuntimeError, match="CUDA"):
        Tester(args, network=net, diff_params=diff)
    assert tsetup.setup_tester(args, network=net, diff_params=diff, device="cpu") is None


def test_in_training_tester_samples_a_private_copy(jax_params):
    """In training the tester samples with its own frozen, remat-free copy:
    loading the EMA into it leaves the trainer's network as it was."""
    args = compose(overrides=TINY + ["network.remat=True"])
    net = tsetup.setup_network(args, device="cpu", trainable=True,
                               state_dict=state_dict_from_flax(jax_params))
    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    t = tsetup.setup_tester(args, network=net, diff_params=tsetup.setup_diff_parameters(args),
                            device="cpu", in_training=True)
    assert t.network is not net and not t.network.remat and net.remat
    assert not any(p.requires_grad for p in t.network.parameters())
    ema = {k: v * 0.5 for k, v in before.items()}
    x = t.sample_unconditional_ema(ema)
    assert x.shape == (1, L) and np.isfinite(x).all()
    for k, v in net.named_parameters():
        assert torch.equal(v, before[k]), k
    for k, v in t.network.named_parameters():
        assert torch.equal(v, ema[k]), k


def test_rid_dumps_one_row_per_file(tmp_path):
    """With tester.rid and two files in one batch, each file's dumps hold
    its own row of the Record ([T, L] per field), with the trajectory's
    filmstrip and animation."""
    pt = _port_tester(tmp_path, ["+tester.rid=True", "tester.batch_size=2", "tester.T=2"])
    pt.test_inpainting()
    d = os.path.join(pt.base_dir, "inpainting", "rid")
    xt = [np.load(os.path.join(d, f"clip_{i}_xt.npy")) for i in range(2)]
    assert xt[0].shape == (2, L) and not np.array_equal(xt[0], xt[1])
    for field in ("denoised", "grads", "grad_update", "pocs", "xt2"):
        assert np.load(os.path.join(d, f"clip_1_{field}.npy")).shape == (2, L), field
    assert os.path.exists(os.path.join(d, "clip_0_trajectory.gif"))
    assert os.path.exists(os.path.join(d, "clip_0_trajectory.png"))
