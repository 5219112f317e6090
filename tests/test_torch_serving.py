"""The port's InpaintingService against the JAX package's.

``find_gaps`` on random masks, and the window / chain scheduler with
``_run_batch`` stubbed by the same deterministic row-wise function in both
services (short gaps, clustered gaps, chained long gaps, short input;
max_batch 1 and 2; inputs at the model's rate and at 16, 44.1 and 48 kHz,
resampled by each package's native libsoxr route): outputs must be equal.
``inpaint_file`` writes the JAX service's file; ``autotune_max_batch`` gives
the JAX service's answer for the same two footprints. Plus ``inpaint`` and
``precompile`` of the tiny network on the CPU.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from aid_tpu.data import audio_io as jaudio
from aid_tpu.serving import InpaintingService as JaxService
from aid_tpu.serving import find_gaps as jax_find_gaps
from aid_tpu_torch import setup as tsetup
from aid_tpu_torch.data import audio_io
from aid_tpu_torch.serving import InpaintingService, find_gaps
from aid_tpu_torch.utils.containers import EasyDict
from tests.torch_native import jax_native
from tests.torch_threads import one_torch_thread  # noqa: F401

L, FS = 1000, 4096


def _stub(xb, mb):
    """Row-wise and deterministic: a gap sample depends on its row's
    observed content, so chained passes see earlier write-backs."""
    obs = xb * mb
    fill = np.cumsum(obs, axis=1) * 1e-2 + np.arange(xb.shape[1]) / xb.shape[1]
    return (obs + (1.0 - mb) * fill).astype(np.float32)


def _services(max_batch, fs=FS):
    args = EasyDict(exp=dict(sample_rate=fs, audio_len=L))
    t = InpaintingService(args=args, network=None, sampler=None, max_batch=max_batch)
    j = JaxService(args=args, bundle=None, sampler=None, max_batch=max_batch)
    calls = {"torch": [], "jax": []}

    def t_run(xb, mb, seed):
        calls["torch"].append(xb.shape[0])
        return _stub(xb, mb)

    def j_run(xb, mb, key):
        calls["jax"].append(xb.shape[0])
        return _stub(xb, mb)

    t._run_batch = t_run
    j._run_batch = j_run
    return t, j, calls


def _mask(n, gaps):
    m = np.ones(n, np.float32)
    for a, b in gaps:
        m[a:b] = 0.0
    return m


CASES = {
    "short": (3500, [(100, 150), (900, 1000), (2000, 2100), (3300, 3350)]),
    "clustered": (2500, [(400, 420), (450, 480), (520, 600), (1900, 1910)]),
    "chained": (4200, [(30, 60), (500, 2300), (2900, 2950), (3000, 3900)]),
    "two_chains": (5000, [(200, 1000), (1500, 3400), (4500, 4510)]),
    "short_input": (700, [(100, 300)]),
}


@pytest.mark.parametrize("seed", range(4))
def test_find_gaps_matches_jax(seed):
    rng = np.random.default_rng(seed)
    m = (rng.random(400) > 0.3).astype(np.float32)
    m[: seed % 2] = 0.0
    assert find_gaps(m) == jax_find_gaps(m)


@pytest.mark.parametrize("max_batch", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_scheduler_matches_jax(case, max_batch):
    n, gaps = CASES[case]
    audio = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    mask = _mask(n, gaps)
    t, j, calls = _services(max_batch)
    got = t.inpaint(audio, mask, FS)
    ref = j.inpaint(audio, mask, FS)
    np.testing.assert_array_equal(got, ref)
    # same number of rounds; the port runs only the rows a round fills
    assert len(calls["torch"]) == len(calls["jax"])
    assert all(r <= max_batch for r in calls["torch"])
    np.testing.assert_array_equal(got[mask > 0.5], audio[mask > 0.5])


MODEL_FS = 22050
FOREIGN_GAPS = [(100, 150), (900, 1000), (1500, 3400), (4000, 4040)]   # input samples


@pytest.fixture
def soxr_in_both():
    assert audio_io.resampler_route() == "soxr"
    assert jax_native() is not None and jaudio._native() is not None


@pytest.mark.parametrize("max_batch", [1, 2])
@pytest.mark.parametrize("fs", [16000, 44100, 48000])
def test_foreign_rate_scheduler_matches_jax(soxr_in_both, fs, max_batch):
    """An input at another rate is resampled to the model's, inpainted and
    resampled back: the port's result is the JAX service's, sample for
    sample, every observed input sample exact and every gap filled."""
    n = 5000
    audio = (np.random.default_rng(4).standard_normal(n) * 0.3).astype(np.float32)
    mask = _mask(n, FOREIGN_GAPS)
    t, j, calls = _services(max_batch, MODEL_FS)
    got = t.inpaint(audio, mask, fs)
    ref = j.inpaint(audio, mask, fs)
    assert got.shape == audio.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert len(calls["torch"]) == len(calls["jax"]) > 0
    np.testing.assert_array_equal(got[mask > 0.5], audio[mask > 0.5])
    assert np.abs(got[mask < 0.5]).min() > 0


def test_inpaint_file_writes_the_jax_file(soxr_in_both, tmp_path):
    """inpaint_file at 48 kHz: the written file is the JAX service's, byte
    for byte, at the input's rate and length; observed samples within one
    16-bit step of the input file's."""
    n, fs = 6000, 48000
    src = str(tmp_path / "in.wav")
    audio_io.write(src, np.sin(np.arange(n) * 0.05) * 0.5, fs)
    mask = _mask(n, [(700, 900), (2000, 4100)])
    t, j, _ = _services(2, MODEL_FS)
    # a quiet fill, so no sample clips and the writer does not normalise
    t._run_batch = lambda xb, mb, seed: 0.1 * _stub(xb, mb)
    j._run_batch = lambda xb, mb, key: 0.1 * _stub(xb, mb)
    assert t.inpaint_file(src, mask, str(tmp_path / "t.wav"), seed=3) == str(tmp_path / "t.wav")
    j.inpaint_file(src, mask, str(tmp_path / "j.wav"), seed=3)
    assert open(tmp_path / "t.wav", "rb").read() == open(tmp_path / "j.wav", "rb").read()
    assert audio_io.info(str(tmp_path / "t.wav")) == (n, fs, 1)
    out, x = audio_io.read(str(tmp_path / "t.wav"))[0], audio_io.read(src)[0]
    assert np.abs(out - x)[mask > 0.5].max() <= 1.0 / 32767
    assert np.abs(out[mask < 0.5]).max() > 0


GIB = 2 ** 30
AUTOTUNE = {                  # f1, f2, limit, configured max_batch, cap
    "fits_many_keeps_1": (3 * GIB, 4 * GIB, 80 * GIB, 1, 16),
    "cap": (3 * GIB, 4 * GIB, 80 * GIB, 2, 4),
    "caps_the_configured": (10 * GIB, 30 * GIB, 80 * GIB, 8, 16),
    "one_row": (5 * GIB, 9 * GIB, 12 * GIB, 2, 16),
    "does_not_fit": (3 * GIB, 4 * GIB, 2 * GIB, 1, 16),
}


@pytest.mark.parametrize("case", sorted(AUTOTUNE))
def test_autotune_max_batch_matches_jax(case):
    """The same two footprints give the JAX service's fit and max_batch, or
    its raise when not one row fits."""
    f1, f2, limit, mb, cap = AUTOTUNE[case]
    foot = {1: f1, 2: f2}
    t, j, _ = _services(mb)
    t._footprint = lambda n: foot[n]
    j._compiled_for_batch = lambda n, seed=0: SimpleNamespace(
        memory_analysis=lambda: SimpleNamespace(argument_size_in_bytes=foot[n] // 2,
                                                output_size_in_bytes=0,
                                                temp_size_in_bytes=foot[n] - foot[n] // 2))
    if case == "does_not_fit":
        for svc in (t, j):
            with pytest.raises(RuntimeError, match="does not fit"):
                svc.autotune_max_batch(limit_bytes=limit, cap=cap)
        return
    got = t.autotune_max_batch(limit_bytes=limit, cap=cap)
    assert got == j.autotune_max_batch(limit_bytes=limit, cap=cap) >= 1
    assert t.max_batch == j.max_batch <= mb


def test_entry_point_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tsetup.resolve_device(None)
    assert tsetup.resolve_device("cpu") == torch.device("cpu")


TINY = ["network.cqt.num_octs=3", "network.cqt.bins_per_oct=8",
        "exp.audio_len=2048", "exp.sample_rate=4096", "network.Ns=[8,16,16]",
        "network.num_dils=[1,2,2]", "network.attention_layers=[0,1,1,1]",
        "network.emb_dim=32", "network.attention_dict.num_heads=2",
        "network.compute_dtype=float32", "tester.T=3"]


def test_inpaint_end_to_end_on_cpu():
    svc = InpaintingService.from_config(TINY, device="cpu")
    assert svc.device == torch.device("cpu") and svc.max_batch == 2
    rng = np.random.default_rng(2)
    n = 5000
    audio = (rng.standard_normal(n) * 0.1).astype(np.float32)
    mask = _mask(n, [(300, 340), (1200, 1300), (2500, 4000)])   # the last chains
    out = svc.inpaint(audio, mask, 4096, seed=3)
    assert out.shape == audio.shape and np.isfinite(out).all()
    np.testing.assert_array_equal(out[mask > 0.5], audio[mask > 0.5])
    assert np.abs(out[mask < 0.5]).min() >= 0 and np.abs(out[mask < 0.5]).max() > 0
    np.testing.assert_array_equal(out, svc.inpaint(audio, mask, 4096, seed=3))


def test_from_config_loads_a_checkpoint(tmp_path):
    """from_config(checkpoint=...) loads a reference-layout .pt written by
    the JAX package's export_checkpoint through the tester, and serves with
    the tester's sampler; a missing file raises FileNotFoundError."""
    import jax
    from aid_tpu import setup as asetup
    from aid_tpu.utils.checkpoint_torch import export_checkpoint
    from aid_tpu.utils.config import compose as jax_compose
    from aid_tpu_torch.utils.convert import state_dict_from_flax
    bundle = asetup.setup_network(jax_compose(overrides=TINY))
    bundle.init(jax.random.PRNGKey(1), 1, 2048)
    path = export_checkpoint(str(tmp_path / "net-5.pt"), bundle, it=5)
    svc = InpaintingService.from_config(TINY, device="cpu", checkpoint=path)
    ref = state_dict_from_flax(bundle.params)
    got = svc.network.state_dict()
    assert set(got) == set(ref)
    for k, v in got.items():
        assert torch.equal(v, ref[k]), k
    assert svc.sampler.model is svc.network
    with pytest.raises(FileNotFoundError):
        InpaintingService.from_config(TINY, device="cpu", checkpoint=str(tmp_path / "none.pt"))


def test_precompile_leaves_a_later_inpaint_unchanged():
    """precompile builds the programs for [max_batch, L] and every smaller
    row count and draws nothing from the global generator or a request's
    noise: a request answered
    after it equals the same request answered before it."""
    svc = InpaintingService.from_config(TINY, device="cpu")
    rng = np.random.default_rng(5)
    audio = (rng.standard_normal(3000) * 0.1).astype(np.float32)
    mask = _mask(3000, [(500, 700), (2000, 2100)])
    before = svc.inpaint(audio, mask, 4096, seed=2)
    state = torch.random.get_rng_state()
    svc.precompile()
    assert torch.equal(torch.random.get_rng_state(), state)
    np.testing.assert_array_equal(svc.inpaint(audio, mask, 4096, seed=2), before)


def test_autotune_on_the_cpu_needs_a_limit_and_a_card():
    svc = InpaintingService.from_config(TINY, device="cpu")
    with pytest.raises(ValueError, match="limit_bytes"):
        svc.autotune_max_batch()
    with pytest.raises(RuntimeError, match="CUDA"):
        svc.autotune_max_batch(limit_bytes=2 ** 30)
