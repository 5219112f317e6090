"""Tests of the port that need an NVIDIA GPU (the Triton kernel has no CPU
mode). They carry the ``cuda`` marker and skip without a card. This file
imports no JAX, so it runs on the card:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider
"""
import pytest
import torch

from aid_tpu_torch.models import unet_cqt as tunet
from aid_tpu_torch.ops import fused_adaln as fa
from aid_tpu_torch.ops.cqt import get_cqt

EPS, G = 1e-7, 8
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Triton kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _data(gen, shape=(2, 8, 16, 16), dtype=torch.float32):
    C = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    gamma = torch.rand(C, generator=gen, device="cuda") + 0.5
    aff = torch.randn(shape[0], C, generator=gen, device="cuda") * 0.3
    return x, gamma, aff


def test_cuda_branch_raises_rather_than_falls_back(cuda):
    x, gamma, aff = _data(cuda)
    xt = x.transpose(1, 2)
    before = fa.launch_count()
    with pytest.raises(ValueError):
        fa.norm_adaln_gelu(xt, fa.group_std(xt, G), gamma, aff, EPS, G)
    assert fa.launch_count() == before


@pytest.mark.parametrize("gelu", fa.GELU_VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8, 16, 16), (1, 64, 32, 96), (3, 7, 5, 256)])
def test_kernel_matches_plain(cuda, gelu, dtype, shape):
    x, gamma, aff = _data(cuda, shape, dtype)
    before = fa.launch_count()
    with torch.no_grad():
        y = fa.norm_adaln_gelu(x, fa.group_std(x, G), gamma, aff, EPS, G, gelu=gelu)
        yp = fa.norm_adaln_gelu_plain(x, fa.group_std(x, G), gamma, aff, EPS, G, gelu=gelu)
    assert fa.launch_count() == before + 1
    assert y.dtype == dtype
    # f32: summation-free elementwise math, libdevice vs torch functions;
    # bf16: one rounding of the same f32 value, so at most one bf16 ulp
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert bool(((y.float() - yp.float()).abs() <= tol * yp.float().abs() + 1e-5).all())


def test_tiny_denoiser_launches_once_per_layer(cuda, monkeypatch):
    net = tunet.UnetCQT(get_cqt(3, 8, 4096.0, 2048), (8, 16, 16), (1, 2, 2),
                        (0, 1, 1, 1), dict(num_heads=2, use_rel_pos=True), emb_dim=32,
                        gelu="tanh").init_weights(0, gate_scale=tunet.MAIN_SCALE).cuda()
    audio = torch.randn(2, 2048, generator=cuda, device="cuda") * 0.1
    cn = torch.tensor([[-0.3], [0.4]], device="cuda")
    fa.reset_launch_count()
    with torch.no_grad():
        y = net(audio, cn)
        n = fa.launch_count()
        monkeypatch.setattr(fa, "norm_adaln_gelu", fa.norm_adaln_gelu_plain)
        yp = net(audio, cn)
    # 3 init + (1+2+2) encoder + 2 bottleneck + 1 out + 5 decoder + 3 out
    assert n == 3 + 5 + 2 + 1 + 5 + 3
    assert ((y - yp).abs().max() / yp.abs().max()).item() < 1e-5


def test_tiny_training_steps_on_the_card_match_the_cpu(cuda, tmp_path):
    """Two remat training steps of the tiny net on mixed-rate native audio,
    on the card and on the CPU from the same weights and draws: the kernel
    launches in the forward and again in the recomputation, and loss,
    pre-clip gradient norm and the update agree (f32, TF32 off; the two
    devices sum in other orders)."""
    import numpy as np

    from aid_tpu_torch import setup as tsetup
    from aid_tpu_torch.train import compose_args

    args = compose_args([
        "exp.audio_len=2048", "exp.lr_rampup_it=1", "network.cqt.num_octs=3",
        "network.cqt.bins_per_oct=8", "network.Ns=[8,16,16]", "network.num_dils=[1,1,1]",
        "network.attention_layers=[0,0,1,1]", "logging.print_model_summary=False",
        f"model_dir={tmp_path}"])
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((4, 4400)) * 0.1).astype(np.float32)
    fs = np.array([44100, 48000, 44100, 48000])
    sigma = np.exp(rng.uniform(-6, 1, 4)).astype(np.float32)
    draws = [{"sign": np.array([[1.0], [-1.0], [-1.0], [1.0]], np.float32), "sigma": sigma,
              "noise": (rng.standard_normal((4, 2048)) * sigma[:, None]).astype(np.float32)}]
    res = {}
    for dev in ("cpu", "cuda"):
        net = tsetup.setup_network(args, device=dev, seed=3, trainable=True)
        tr = tsetup.setup_trainer(args, network=net, diff_params=tsetup.setup_diff_parameters(args))
        tr.init_state()
        p0 = [p.detach().cpu().clone() for p in tr.params]
        fa.reset_launch_count()
        metrics = [tr.train_step(audio, fs, draws) for _ in range(2)]
        per_fwd = sum(m.num_dils for m in net.modules() if isinstance(m, tunet.AdaLNResBlock))
        res[dev] = (fa.launch_count(), 2 * 2 * per_fwd,
                    [(float(m["loss"]), float(m["grad_norm"])) for m in metrics],
                    [p.detach().cpu() - a for p, a in zip(tr.params, p0)])
    assert res["cpu"][0] == 0 and res["cuda"][0] == res["cuda"][1]
    np.testing.assert_allclose(res["cuda"][2], res["cpu"][2], rtol=1e-4)
    num = sum(float((a - b).double().pow(2).sum()) for a, b in zip(res["cuda"][3], res["cpu"][3]))
    den = sum(float(b.double().pow(2).sum()) for b in res["cpu"][3])
    assert den > 0 and (num / den) ** 0.5 <= 1e-2


def test_tiny_program_graphs_equal_eager(cuda):
    """The sampler's inpainting program, captured as CUDA graphs, against
    ``heun_sample`` run eagerly on the same noise (tiny net, f32, TF32
    off): the Triton launches inside the graphs are counted per replay, the
    results agree, and a second run does not alias the first."""
    from aid_tpu_torch import setup as tsetup
    from aid_tpu_torch.sampling import degradations as degr
    from aid_tpu_torch.sampling import heun
    from aid_tpu_torch.utils.config import compose

    args = compose(overrides=[
        "network.cqt.num_octs=3", "network.cqt.bins_per_oct=8", "exp.audio_len=2048",
        "exp.sample_rate=4096", "network.Ns=[8,16,16]", "network.num_dils=[1,2,2]",
        "network.attention_layers=[0,1,1,1]", "network.emb_dim=32",
        "network.attention_dict.num_heads=2", "network.compute_dtype=float32", "tester.T=4"])
    net = tsetup.setup_network(args, device="cuda", seed=0)
    s = tsetup.setup_sampler(args, net, tsetup.setup_diff_parameters(args))
    mask = torch.ones(2, 2048, device="cuda")
    mask[:, 700:1100] = 0.0
    y = torch.randn(2, 2048, generator=cuda, device="cuda") * 0.1 * mask
    prior, churn = heun.draw_noise((2, 2048), s.cfg.T, cuda, "cuda")
    prog = s.compile_inpainting(y, mask)          # warm-up and capture
    fa.reset_launch_count()
    got = s.predict_inpainting(y, mask, prior=prior, churn=churn)
    torch.cuda.synchronize()
    assert list(s._programs.values()) == [prog]
    assert prog.graphs is not None and prog.replays == s.cfg.T
    assert fa.launch_count() == prog.launches_per_run() > 0
    assert prog.memory_bytes() > prog.static_bytes()
    smooth = s._smooth_mask(mask)
    proj = degr.inpainting_projector(y, smooth)
    score = heun.make_score_fn(s.p, s.cfg, s._denoise, y=y, degradation=degr.time_mask(mask),
                               proj=proj, hpf=s._hpf())
    ref = heun.heun_sample((2, 2048), s.p, s.cfg, score, proj_end=proj, prior=prior,
                           churn=churn)
    assert torch.isfinite(ref).all()
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-5
    kept = got.clone()
    other = s.predict_inpainting(0.5 * y, mask, prior=churn[0], churn=churn.flip(0))
    assert torch.equal(got, kept) and not torch.equal(got, other)
