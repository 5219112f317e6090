"""DiffWave in the port (``models/diffwave.py``, ``ops/gated_tanh.py``) against
the plain float32 reference ``tests/diffwave_reference.py``, on the CPU at a
tiny size (C=8, 6 layers, dilation cycle 3, 2048 samples), and on its
normal path: one round of ``InpaintingService.inpaint`` and one captured
``Trainer`` step with remat. The gate kernel's tests against its plain
version carry the ``cuda`` marker and skip without a card. Imports no JAX.
"""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from aid_tpu_torch import setup as tsetup
from aid_tpu_torch.diffusion import edm
from aid_tpu_torch.models import diffwave as dw
from aid_tpu_torch.ops import gated_tanh as gt
from aid_tpu_torch.serving import InpaintingService
from aid_tpu_torch.utils import trace
from aid_tpu_torch.utils.config import compose
from tests import diffwave_reference as ref

TINY = dict(residual_channels=8, residual_layers=6, dilation_cycle_length=3, emb_dim=16,
            emb_hidden=32)
L = 2048
WORDS = ["network=diffwave_16k", "exp=librispeech16k_8s", "network.residual_channels=8",
         "network.residual_layers=6", "network.dilation_cycle_length=3", "network.emb_dim=16",
         "network.emb_hidden=32", "network.compute_dtype=float32", f"exp.audio_len={L}"]


def _weights(net, seed=0):
    """Every parameter uniform in +-1/sqrt(fan in), biases too (nothing zero)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in sorted(net.state_dict().items()):
        fan = p[0].numel() if p.dim() >= 2 else p.numel()
        out[name] = (torch.rand(p.shape, generator=gen) * 2 - 1) / math.sqrt(fan)
    return out


def _pair(seed=0, **kw):
    port = dw.DiffWave(**TINY, **kw)
    state = _weights(port, seed)
    port.load_state_dict(state)
    reference = ref.DiffWave(**TINY)
    reference.load_state_dict(state)
    return port, reference


def _rel(a, b):
    return float((a - b).detach().norm() / b.detach().norm())


@pytest.mark.parametrize("fold_from,length", [(dw.FOLD_FROM, L), ({torch.float32: 2}, L),
                                              ({torch.float32: 2}, 3001)],
                         ids=["card_forms", "folded", "folded_ragged"])
def test_forward_matches_the_reference(fold_from, length, monkeypatch):
    """With the card's choice of conv forms (in f32 every dilation
    unfolded) and with every dilation from 2 folded, also at a length that
    the folded dilations do not divide."""
    monkeypatch.setattr(dw, "FOLD_FROM", fold_from)
    port, reference = _pair()
    gen = torch.Generator().manual_seed(1)
    audio = torch.randn(2, length, generator=gen)
    t = torch.tensor([[-1.7], [0.2]])
    with torch.no_grad():
        assert _rel(port(audio, t), reference(audio, t)) <= 1e-5


@pytest.mark.parametrize("fold_from", [dw.FOLD_FROM, {torch.float32: 2}],
                         ids=["card_forms", "folded"])
def test_guided_score_gradient_matches_the_reference(fold_from, monkeypatch):
    """The input gradient of the guidance norm ||y - m D(x)|| through EDM's
    preconditioning: the port's net (the gate's own backward, the folded
    convs' autograd) against the reference's autograd."""
    monkeypatch.setattr(dw, "FOLD_FROM", fold_from)
    port, reference = _pair(seed=3)
    p = edm.EDMParams(sigma_data=0.063, sigma_min=1e-4, sigma_max=1.0)
    gen = torch.Generator().manual_seed(2)
    x = 0.3 * torch.randn(2, L, generator=gen)
    y = 0.05 * torch.randn(2, L, generator=gen)
    mask = torch.ones(2, L)
    mask[:, 700:1300] = 0.0
    sigma = torch.full((2, 1), 0.3)
    grads = []
    for net in (port, reference):
        xg = x.clone().requires_grad_(True)
        r = (y - mask * edm.denoiser(p, net, xg, sigma)).reshape(2, -1)
        (g,) = torch.autograd.grad(r.square().sum(-1).sqrt().sum(), xg)
        grads.append(g)
    assert _rel(*grads) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_plain_path_and_autograd(dtype):
    """The CPU path of ``gated_tanh`` is the formula in f32 math, and its
    backward the formula's autograd."""
    gen = torch.Generator().manual_seed(4)
    z = (3.0 * torch.randn(2, 16, 100, generator=gen)).to(dtype)
    zf = z.float().requires_grad_(True)
    want = torch.sigmoid(zf[:, :8]) * torch.tanh(zf[:, 8:])
    zg = z.clone().requires_grad_(True)
    got = gt.gated_tanh(zg)
    assert got.dtype == dtype and torch.equal(got, want.to(dtype))
    dg = torch.randn(2, 8, 100, generator=gen).to(dtype)
    (gz,) = torch.autograd.grad(got, zg, dg)
    (wz,) = torch.autograd.grad(want, zf, dg.float())
    assert gz.dtype == dtype and torch.allclose(gz.float(), wz.to(dtype).float(), rtol=0,
                                                atol=float(wz.abs().max()) * 2 ** -7)


def test_gate_gradcheck_float64():
    z = torch.randn(2, 6, 9, dtype=torch.float64, generator=torch.Generator().manual_seed(5))
    assert torch.autograd.gradcheck(gt.gated_tanh, (z.requires_grad_(True),))


@pytest.mark.parametrize("d,L", [(1, 4096), (2, 4096), (16, 4096), (256, 4096), (2048, 4096),
                                 (16, 3000), (2048, 4100)])
def test_folded_conv_equals_the_dilated_conv(d, L):
    """Exactly, in f32: small integers, so every product and sum is exact
    in any order the two convs take; a length the dilation does not
    divide too."""
    gen = torch.Generator().manual_seed(d)
    x = torch.randint(-8, 9, (2, 8, L), generator=gen).float()
    w = torch.randint(-8, 9, (16, 8, 3), generator=gen).float()
    b = torch.randint(-8, 9, (16,), generator=gen).float()
    want = F.conv1d(x, w, b, padding=d, dilation=d)
    assert torch.equal(dw.dilated_conv1d(x, w, b, d, "folded"), want)
    assert torch.equal(dw.dilated_conv1d(x, w, b, d, "dilated"), want)


def _param_count(residual_channels, residual_layers, emb_dim, emb_hidden, **_):
    """Parameters by the layer equations: the input 1x1 conv, the two
    embedding layers, each layer's dilated conv, step projection and 1x1
    conv, the skip and output 1x1 convs, each with its bias."""
    C, H = residual_channels, emb_hidden
    layer = (3 * C * 2 * C + 2 * C) + (H * C + C) + (C * 2 * C + 2 * C)
    return 2 * C + (emb_dim * H + H) + (H * H + H) + residual_layers * layer + (C * C + C) + C + 1


def test_state_dict_names_and_the_published_size():
    """lmnt's state-dict keys and shapes; 24,034,305 parameters at the
    published sizes, counted from the equations without building the net."""
    port = dw.DiffWave(**TINY)
    shapes = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert shapes == {k: tuple(v.shape) for k, v in ref.DiffWave(**TINY).state_dict().items()}
    C, H = 8, 32
    assert shapes["input_projection.weight"] == (C, 1, 1)
    assert shapes["diffusion_embedding.projection1.weight"] == (H, 16)
    assert shapes["diffusion_embedding.projection2.weight"] == (H, H)
    assert shapes["residual_layers.5.dilated_conv.weight"] == (2 * C, C, 3)
    assert shapes["residual_layers.5.diffusion_projection.weight"] == (C, H)
    assert shapes["residual_layers.5.output_projection.weight"] == (2 * C, C, 1)
    assert shapes["skip_projection.weight"] == (C, C, 1)
    assert shapes["output_projection.weight"] == (1, C, 1)
    assert len(shapes) == 2 * (1 + 2 + 3 * 6 + 2)     # a weight and a bias a layer
    assert [layer.dilated_conv.dilation[0] for layer in port.residual_layers] == [1, 2, 4] * 2
    assert sum(v.numel() for v in port.parameters()) == _param_count(**TINY)
    assert _param_count(256, 36, 128, 512) == 24_034_305


@pytest.mark.parametrize("word,error", [("network.context_parallel=True", "context_parallel"),
                                        ("network.remat_policy=conv", "remat_policy"),
                                        ("network.quant=int4", "quant")])
def test_options_it_does_not_take_raise(word, error):
    with pytest.raises(ValueError, match=error):
        dw.build_diffwave(compose(overrides=WORDS + [word]))


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_lower_precision_paths_run_and_differ(quant):
    """``quant=int8`` routes every conv through ``ops.qconv``, ``fp8``
    rounds every conv's input and weight to float8 e4m3: each close to the
    float net, not equal, and differentiable in the input."""
    port, _ = _pair(seed=6)
    q = dw.DiffWave(**TINY, quant=quant)
    q.load_state_dict(port.state_dict())
    audio = torch.randn(2, L, generator=torch.Generator().manual_seed(7)).requires_grad_(True)
    t = torch.tensor([[-0.5], [-0.5]])
    a, b = port(audio, t), q(audio, t)
    assert 0 < _rel(b, a) < 0.1
    (g,) = torch.autograd.grad(b.sum(), audio)
    assert torch.isfinite(g).all() and g.abs().sum() > 0


def test_one_inpainting_round_gives_back_every_observed_sample():
    """``InpaintingService`` serves the net through ``Sampler`` and its
    program: two gaps of one request in one 2-row round, the observed
    samples back exactly, the gaps filled."""
    args = compose(overrides=WORDS + ["tester.T=3"])
    net = tsetup.setup_network(args, device="cpu", state_dict=_weights(dw.build_diffwave(args)))
    sampler = tsetup.setup_sampler(args, network=net,
                                   diff_params=tsetup.setup_diff_parameters(args))
    svc = InpaintingService(args=args, network=net, sampler=sampler, max_batch=2)
    rng = np.random.default_rng(8)
    audio = (0.05 * rng.standard_normal(5000)).astype(np.float32)
    mask = np.ones(5000, np.float32)
    mask[1000:1100] = mask[3900:4100] = 0.0
    out = svc.inpaint(audio, mask, 16000, seed=9)
    assert np.array_equal(out[mask > 0], audio[mask > 0])
    assert np.isfinite(out).all() and not np.array_equal(out[1000:1100], audio[1000:1100])
    assert len(sampler._programs) == 1
    assert "gated_tanh.launches" in trace.snapshot()["counters"]


def test_one_trainer_step_with_remat_against_the_reference_loss(tmp_path):
    """One step of the captured training program (the eager program on the
    CPU) with remat on: its loss is the reference's EDM loss on the same
    draws, and the step moves no parameter (the first update's rate is 0)."""
    args = compose(overrides=WORDS + ["network.remat=True", "exp.batch=2",
                                      f"model_dir={tmp_path}", "logging.print_model_summary=False"])
    state = _weights(dw.build_diffwave(args), seed=10)
    net = tsetup.setup_network(args, device="cpu", state_dict=state, trainable=True)
    assert net.remat
    diff = tsetup.setup_diff_parameters(args)
    tr = tsetup.setup_trainer(args, network=net, diff_params=diff)
    tr.init_state()
    rng = np.random.default_rng(11)
    audio = (0.1 * rng.standard_normal((2, L))).astype(np.float32)
    sigma = np.array([0.05, 1.5], np.float32)
    draws = [{"sign": np.array([[1.0], [-1.0]], np.float32), "sigma": sigma,
              "noise": (rng.standard_normal((2, L)) * sigma[:, None]).astype(np.float32)}]
    m = tr._train_step(audio, np.array([16000, 16000]), draws, program=True)
    assert tr.step_programs_built == 1

    reference = ref.DiffWave(**TINY)
    reference.load_state_dict(state)
    x = torch.from_numpy(audio) * torch.from_numpy(draws[0]["sign"])
    s = torch.from_numpy(sigma).reshape(-1, 1)
    inp, target, cn = edm.prepare_train_preconditioning(
        diff.params, x, s, noise=torch.from_numpy(draws[0]["noise"]))
    with torch.no_grad():
        want = (reference(inp, cn) - target).square().mean()
    assert abs(float(m["loss"]) - float(want)) <= 1e-5 * float(want)
    assert all(torch.equal(p, state[n]) for n, p in zip(tr.names, tr.params))


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the gate's Triton kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_kernels_match_the_plain_version(cuda, dtype):
    """Forward and backward kernels against the plain version on the same
    card, in bf16 and f32, on a shape whose halves end inside a block."""
    z = (3.0 * torch.randn(2, 512, 3001, generator=cuda, device="cuda")).to(dtype)
    dg = torch.randn(2, 256, 3001, generator=cuda, device="cuda").to(dtype)
    f0, b0 = gt.LAUNCHES.count(), gt.LAUNCHES.count(bwd=True)
    got, dz = gt._gated_cuda(z), gt._gated_bwd_cuda(z, dg)
    assert (gt.LAUNCHES.count(), gt.LAUNCHES.count(bwd=True)) == (f0 + 1, b0 + 1)
    want, dwant = gt.gated_tanh_plain(z), gt.gated_tanh_bwd_plain(z, dg)
    tol = 1e-6 if dtype == torch.float32 else 2 ** -8
    assert torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.allclose(dz.float(), dwant.float(), rtol=tol, atol=tol * float(dwant.abs().max()))
    zg = z.clone().requires_grad_(True)
    (gz,) = torch.autograd.grad(gt.gated_tanh(zg), zg, dg)
    assert torch.equal(gz, dz)


def test_the_training_entry_trains_it_and_writes_a_demo(tmp_path, capsys):
    """``python -m aid_tpu_torch.train network=diffwave_16k
    exp=librispeech16k_8s`` on a LibriSpeech-layout folder of 16 kHz WAVs:
    two steps with the entry's defaults (remat on, f32), then the EMA demo
    of 3000 samples, a length the folded convs' dilations do not divide."""
    from aid_tpu_torch import train as ttrain
    from aid_tpu_torch.data import audio_io
    corpus = tmp_path / "speech" / "19" / "198"
    corpus.mkdir(parents=True)
    rng = np.random.default_rng(12)
    for j in range(2):
        audio_io.write(str(corpus / f"19-198-{j:04d}.wav"), 0.1 * rng.standard_normal(5000), 16000)
    words = [w for w in WORDS if not w.startswith("network.compute_dtype")]
    md = tmp_path / "run"
    assert ttrain.main(words + ["dset=librispeech", f"dset.path={tmp_path / 'speech'}",
                                "exp.batch=2", "exp.total_its=2", "logging.log_interval=1",
                                "logging.heavy_log_interval=2", "logging.print_model_summary=False",
                                "tester.T=2", "tester.unconditional.num_samples=1",
                                "tester.unconditional.audio_len=3000", f"model_dir={md}"],
                       device="cpu") == 0
    out = capsys.readouterr().out
    assert "it 2  loss" in out and "done at iteration 2" in out
    x, fs = audio_io.read(str(md / "heavy_logging" / "it_2" / "uncond_0.wav"))
    assert x.shape == (3000,) and fs == 16000 and np.isfinite(x).all()
