"""The port's InpaintingService against the JAX package's.

``find_gaps`` on random masks, and the window / chain scheduler with
``_run_batch`` stubbed by the same deterministic row-wise function in both
services (short gaps, clustered gaps, chained long gaps, short input;
max_batch 1 and 2): outputs must be equal. Plus one end-to-end ``inpaint``
of the tiny network on the CPU.
"""
import numpy as np
import pytest
import torch

from aid_tpu.serving import InpaintingService as JaxService
from aid_tpu.serving import find_gaps as jax_find_gaps
from aid_tpu_torch import setup as tsetup
from aid_tpu_torch.serving import InpaintingService, find_gaps
from aid_tpu_torch.utils.containers import EasyDict
from tests.torch_threads import one_torch_thread  # noqa: F401

L, FS = 1000, 4096


def _stub(xb, mb):
    """Row-wise and deterministic: a gap sample depends on its row's
    observed content, so chained passes see earlier write-backs."""
    obs = xb * mb
    fill = np.cumsum(obs, axis=1) * 1e-2 + np.arange(xb.shape[1]) / xb.shape[1]
    return (obs + (1.0 - mb) * fill).astype(np.float32)


def _services(max_batch):
    args = EasyDict(exp=dict(sample_rate=FS, audio_len=L))
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


def test_foreign_sample_rate_raises():
    t, _, _ = _services(1)
    with pytest.raises(NotImplementedError):
        t.inpaint(np.zeros(1500, np.float32), _mask(1500, [(10, 20)]), FS // 2)


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
