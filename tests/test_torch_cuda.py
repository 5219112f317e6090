"""Tests of the port that need an NVIDIA GPU (the Triton kernel has no CPU
mode). They carry the ``cuda`` marker and skip without a card. This file
imports no JAX, so it runs on the card:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider
"""
import gc
import weakref

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


# Launch shapes (B, R, C) of the backward kernel: every column width of both
# flagships, the widest and narrowest row counts they launch, ragged row
# counts (no whole tile, no whole program), batch 1, 2 and 4.
BWD_SHAPES = [(1, 262144, 64), (2, 131072, 96), (4, 40960, 128), (2, 14336, 256),
              (1, 2048, 256), (4, 4099, 96), (2, 8191, 128), (1, 77, 64)]
DX_F32_ULPS = 4.0          # f32 dx: at most 1.48 ulps read on an H100
NEEDS = {"all": (True, True, True), "dx_inv": (True, True, False),
         "dx": (True, False, False), "tables": (False, True, True)}


def _bwd_inputs(gen, B, R, C, dtype):
    x = torch.randn((B, R, C), generator=gen, device="cuda").to(dtype)
    g = torch.randn((B, R, C), generator=gen, device="cuda").to(dtype)
    inv = torch.rand(B, C, generator=gen, device="cuda") + 0.5
    mod = torch.rand(B, C, generator=gen, device="cuda") + 0.5
    return x, g, inv, mod


def _bwd_grads(x, g, inv, mod, gelu, need):
    """(dx, dinv, dmod) of ``_Fused``'s backward for the flags ``need``."""
    xs, invs, mods = (t.detach().requires_grad_(n) for t, n in zip((x, inv, mod), need))
    y = fa._Fused.apply(xs, invs, mods, gelu)
    wrt = [t for t in (xs, invs, mods) if t.requires_grad]
    got = iter(torch.autograd.grad(y, wrt, g))
    return [next(got) if n else None for n in need]


def _bwd_exact(x, g, inv, mod, gelu):
    """The plain backward's formula in float64: (dx, q, sum over rows of
    |dv x|)."""
    s = (inv.double() * mod.double())[:, None, :]
    xd = x.double()
    dv = g.double() * fa._gelu_grad(xd * s, gelu)
    return dv * s, (dv * xd).sum(1), (dv * xd).abs().sum(1)


def _dx_ulps(dx, exact, g, inv, mod):
    """max |dx - exact| in ulps of dx's dtype at |exact|, over a floor of
    one f32 ulp of |g s| (where dv cancels to near 0)."""
    ulp = 2.0 ** -7 if dx.dtype == torch.bfloat16 else 2.0 ** -23
    floor = (g.double() * (inv.double() * mod.double())[:, None, :]).abs() * 2.0 ** -23
    return ((dx.double() - exact).abs() / (ulp * exact.abs() + floor + 1e-300)).max().item()


@pytest.mark.parametrize("need", sorted(NEEDS))
@pytest.mark.parametrize("gelu", fa.GELU_VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_matches_plain_backward(cuda, dtype, gelu, need):
    """The backward kernel against the plain backward's formula, at every
    shape of ``BWD_SHAPES``, evaluated in float64 (the plain backward's own
    f32 tanh and sigmoid tails cancel, 1 + th and 1 - th^2 near |th| = 1,
    and stray up to ~4.6 f32 ulps, so the exact value is the yardstick): dx
    within one ulp of x's dtype in bf16, within DX_F32_ULPS f32 ulps in
    f32 (libdevice's erf and the approximate exp and divide), never farther
    than the plain backward plus one ulp; the row sums within 1e-5 of the
    sum of |dv x| (another order of the same f32 terms). One launch a
    backward, none counted as a forward launch."""
    flags = NEEDS[need]
    for B, R, C in BWD_SHAPES:
        x, g, inv, mod = _bwd_inputs(cuda, B, R, C, dtype)
        fwd, bwd = fa.launch_count(), fa.bwd_launch_count()
        dx, dinv, dmod = _bwd_grads(x, g, inv, mod, gelu, flags)
        assert fa.launch_count() == fwd + 1 and fa.bwd_launch_count() == bwd + 1
        dx64, q64, scale = _bwd_exact(x, g, inv, mod, gelu)
        if flags[0]:
            assert dx.dtype == dtype and dx.shape == x.shape
            got = _dx_ulps(dx, dx64, g, inv, mod)
            plain = _dx_ulps(fa.fused_bwd_plain(x, g, inv, mod, gelu)[0], dx64, g, inv, mod)
            bound = 1.0 if dtype == torch.bfloat16 else DX_F32_ULPS
            assert got <= bound and got <= plain + 1.0, (B, R, C, got, plain)
        else:
            assert dx is None
        for got, table in ((dinv, mod), (dmod, inv)):
            if got is None:
                continue
            assert got.dtype == torch.float32 and got.shape == (B, C)
            ref = q64 * table.double()
            assert bool(((got.double() - ref).abs()
                         <= 1e-5 * scale * table.double() + 1e-30).all()), (B, R, C)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_is_deterministic(cuda, dtype):
    """Two backward runs on the same inputs are bit-identical: the row sums
    are taken in one fixed order, with no atomics."""
    for B, R, C in BWD_SHAPES[:4]:
        x, g, inv, mod = _bwd_inputs(cuda, B, R, C, dtype)
        a = fa._fused_bwd_cuda(x, g, inv, mod, "tanh")
        b = fa._fused_bwd_cuda(x, g, inv, mod, "tanh")
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_bwd_kernel_replayed_in_a_graph_equals_eager(cuda):
    """The backward captured in a CUDA graph and replayed gives the eager
    run's dx and row sums bit for bit; the capture's launch is counted when
    replayed (``trace.captured_launches``, ``trace.replayed_launches``)."""
    from aid_tpu_torch.utils import graphs, trace
    x, g, inv, mod = _bwd_inputs(cuda, 2, 14336, 256, torch.bfloat16)
    ref = fa._fused_bwd_cuda(x, g, inv, mod, "tanh")
    stream = graphs.capture_stream("cuda")
    fn = lambda: fa._fused_bwd_cuda(x, g, inv, mod, "tanh")    # noqa: E731
    graphs.warm_up([fn], stream)
    graph, out, launches, _ = graphs.capture(fn, stream, what="the backward kernel")
    assert launches["fused_adaln"] == (0, 1)
    fa.reset_launch_count()
    graph.replay()
    trace.replayed_launches(launches)
    torch.cuda.synchronize()
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert (fa.launch_count(), fa.bwd_launch_count()) == (0, 1)


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
    on the card (the captured step program) and on the CPU from the same
    weights and draws: the kernel launches in the forward and again in the
    recomputation (and in the program's warm-up), and loss,
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
        # on the card the step program's build runs one more step as its warm-up
        res[dev] = (fa.launch_count(), (2 + tr.step_programs_built) * 2 * per_fwd,
                    [(float(m["loss"]), float(m["grad_norm"])) for m in metrics],
                    [p.detach().cpu() - a for p, a in zip(tr.params, p0)],
                    fa.bwd_launch_count())
    assert res["cpu"][0] == 0 and res["cuda"][0] == res["cuda"][1]
    # one backward launch for two forward ones (the forward and its recomputation)
    assert res["cpu"][4] == 0 and 2 * res["cuda"][4] == res["cuda"][1]
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
    # denoiser calls counted where the captures recorded them, order 2
    assert prog.scores == {"body": 2, "last": 1}
    assert prog.replayed_scores == prog.scores_per_run() == 2 * (s.cfg.T - 1) + 1
    assert fa.launch_count() == prog.launches_per_run() > 0
    # every guided score differentiates one forward: a backward launch per forward one
    assert fa.bwd_launch_count() == prog.launches_per_run(bwd=True) == prog.launches_per_run()
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


TINY_SAMPLER = ["network.cqt.num_octs=3", "network.cqt.bins_per_oct=8", "exp.audio_len=2048",
                "exp.sample_rate=4096", "network.Ns=[8,16,16]", "network.num_dils=[1,2,2]",
                "network.attention_layers=[0,1,1,1]", "network.emb_dim=32",
                "network.attention_dict.num_heads=2", "network.compute_dtype=float32",
                "tester.T=4", "tester.spectrogram_inpainting.stft.n_fft=256",
                "tester.spectrogram_inpainting.stft.hop_length=64",
                "tester.spectrogram_inpainting.stft.win_length=256"]
TASKS = ["inpainting", "unconditional", "spectrogram_inpainting", "bwe", "declipping",
         "phase_retrieval", "compsens", "inpainting_rid"]


def _task_call(s, task, x, gen, noise):
    """A call of the sampler's ``task`` on the signal ``x`` [2, 2048]."""
    from aid_tpu_torch.sampling import degradations as degr
    stft = s.args.tester.spectrogram_inpainting.stft
    if task.startswith("inpainting"):
        mask = torch.ones_like(x)
        mask[:, 700:1100] = 0.0
        return s.predict_inpainting(x * mask, mask, **noise)
    if task == "unconditional":
        return s.predict_unconditional(tuple(x.shape), **noise)
    if task == "spectrogram_inpainting":
        frames = 1 + (2048 + 256 - 2048 % 256) // 64
        m = torch.ones(129, frames, device="cuda")
        m[10:40, 6:14] = 0.0
        return s.predict_spectrogram_inpainting(degr.spectral_mask(m, stft)(x), m, **noise)
    if task == "bwe":
        return s.predict_bwe(degr.bwe_lowpass("firwin", 64, 400.0, 4096.0)(x), 400.0, 4096.0,
                             order=64, **noise)
    if task == "declipping":
        cv = degr.clip_value_from_sdr(x, 3.0)
        return s.predict_declipping(degr.hard_clip(cv)(x), cv, **noise)
    if task == "phase_retrieval":
        return s.predict_phase_retrieval(degr.stft_magnitude(stft)(x), tuple(x.shape), **noise)
    mask = degr.compsens_mask(tuple(x.shape), 20.0, gen, "cuda")
    return s.predict_compsens(x * mask, mask, **noise)


@pytest.mark.parametrize("task", TASKS)
def test_tiny_task_programs_graphs_equal_eager(cuda, task):
    """Each task's program (and ``rid``'s), captured as CUDA graphs, against
    the same task run eagerly on the same noise and inputs (tiny net, f32,
    TF32 off): a replayed run launches what its captures recorded, x and
    every Record field agree, and the program's memory includes its buffers."""
    from aid_tpu_torch import setup as tsetup
    from aid_tpu_torch.sampling import heun
    from aid_tpu_torch.utils.config import compose

    args = compose(overrides=TINY_SAMPLER)
    net = tsetup.setup_network(args, device="cuda", seed=0)
    s = tsetup.setup_sampler(args, net, tsetup.setup_diff_parameters(args),
                             rid=task.endswith("rid"))
    x = torch.randn(2, 2048, generator=cuda, device="cuda") * 0.1
    prior, churn = heun.draw_noise((2, 2048), s.cfg.T, cuda, "cuda")
    noise = dict(prior=prior, churn=churn)
    _task_call(s, task, x, torch.Generator(device="cuda").manual_seed(1), noise)   # builds
    (prog,) = s._programs.values()
    fa.reset_launch_count()
    got = _task_call(s, task, x, torch.Generator(device="cuda").manual_seed(1), noise)
    torch.cuda.synchronize()
    assert prog.graphs is not None and fa.launch_count() == prog.launches_per_run() > 0
    assert fa.bwd_launch_count() == prog.launches_per_run(bwd=True)
    assert (prog.launches_per_run(bwd=True) == 0) == (task == "unconditional")
    assert prog.memory_bytes() > prog.static_bytes()
    s.programs_enabled = lambda: False
    ref = _task_call(s, task, x, torch.Generator(device="cuda").manual_seed(1), noise)
    got, ref = ([got[0], *got[1]], [ref[0], *ref[1]]) if s.rid else ([got], [ref])
    assert len(got) == len(ref) == (7 if s.rid else 1)
    for g, r in zip(got, ref):
        assert torch.isfinite(r).all()
        assert ((g - r).abs().max() / r.abs().max().clamp_min(1e-30)).item() <= 1e-5


def _tiny_trainer(tmp_path, *extra):
    from aid_tpu_torch import setup as tsetup
    from aid_tpu_torch.train import compose_args

    args = compose_args([
        "exp.audio_len=2048", "exp.lr_rampup_it=1", "network.cqt.num_octs=3",
        "network.cqt.bins_per_oct=8", "network.Ns=[8,16,16]", "network.num_dils=[1,1,1]",
        "network.attention_layers=[0,0,1,1]", "logging.print_model_summary=False",
        f"model_dir={tmp_path}", *extra])
    net = tsetup.setup_network(args, device="cuda", seed=3, trainable=True)
    return tsetup.setup_trainer(args, network=net, diff_params=tsetup.setup_diff_parameters(args))


def _replayed_against_eager(tr, graphs=1):
    """``compile_step`` leaves the state, ``it`` and the generator as they
    were; the replayed step agrees with the eager step from the same state
    and draws (loss to 1e-5, the update to 1e-4 in L2: cuDNN's weight
    gradients may sum in another order), launches what its capture
    recorded, and one step's metrics do not alias the next's."""
    import numpy as np

    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((4, 4400)) * 0.1).astype(np.float32)
    fs = np.array([44100, 48000, 44100, 48000])
    tr.init_state()
    # detached copies: a copy that kept the autograd graph would hold the
    # parameters' gradient accumulators on this stream, and the capture fails
    state = [t.detach().clone() for t in tr._state()]
    gen, it = tr.gen.get_state(), tr.it
    prog = tr.compile_step(audio, fs)
    assert len(prog.graphs) == graphs and prog.replay_launches() > 0 and prog.memory_bytes() > 0
    assert all(torch.equal(a, b) for a, b in zip(tr._state(), state))
    assert tr.it == it and torch.equal(tr.gen.get_state(), gen)
    tr.train_step(audio, fs)                       # step 1 (lr 0), replayed
    before, it = tr._snapshot(), tr.it
    p1 = [p.detach().clone() for p in tr.params]
    draws = tr.gen.get_state()
    eager = tr._train_step(audio, fs, None, program=False)
    p_eager = [p.detach().clone() for p in tr.params]
    before()
    tr.it = it
    tr.gen.set_state(draws)
    fa.reset_launch_count()
    m = tr.train_step(audio, fs)
    torch.cuda.synchronize()
    assert tr.step_programs_built == 1 and fa.launch_count() == prog.replay_launches()
    assert 2 * fa.bwd_launch_count() == 2 * prog.replay_launches(bwd=True) == prog.replay_launches()
    assert prog.replays == 2
    assert abs(float(m["loss"]) - float(eager["loss"])) <= 1e-5 * abs(float(eager["loss"]))
    num = sum(float((a.detach() - b).double().pow(2).sum()) for a, b in zip(tr.params, p_eager))
    den = sum(float((b - a).double().pow(2).sum()) for a, b in zip(p1, p_eager))
    assert den > 0 and (num / den) ** 0.5 <= 1e-4
    kept = {k: v.clone() for k, v in m.items() if torch.is_tensor(v)}
    tr.train_step(audio, fs)
    assert all(torch.equal(m[k], v) for k, v in kept.items())


def test_tiny_step_program_on_the_card(cuda, tmp_path):
    """The trainer's captured step (tiny net, remat, f32, TF32 off), held
    against its eager step (``_replayed_against_eager``)."""
    _replayed_against_eager(_tiny_trainer(tmp_path))


@pytest.fixture
def nccl(cuda):
    """A one-rank NCCL process group on the card for the test's duration."""
    import torch.distributed as dist

    from aid_tpu_torch.parallel import mesh as pmesh
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{pmesh._free_port()}",
                            rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield
    finally:
        gc.collect()              # every graph that holds the communicator, first
        torch.cuda.synchronize()
        dist.destroy_process_group()


def test_a_captured_nccl_all_reduce_equals_eager(nccl):
    """NCCL's collectives can be captured (after a first eager call, which
    makes the communicator): a replayed all-reduce equals the eager one."""
    from aid_tpu_torch.parallel import mesh as pmesh
    from aid_tpu_torch.utils import graphs

    assert pmesh.captures_collectives()
    x = torch.arange(4096, dtype=torch.float32, device="cuda")
    buf = torch.zeros_like(x)

    def fn():
        y = buf * 3 + 1
        pmesh.all_reduce(y)
        return y

    stream = graphs.capture_stream("cuda")
    graphs.warm_up([fn], stream)
    g, out, _, _ = graphs.capture(fn, stream, what="an all-reduce")
    buf.copy_(x)
    g.replay()
    ref = x * 3 + 1
    pmesh.all_reduce(ref)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("mode", ["dp", "fsdp", "fsdp_every_tensor"])
def test_tiny_step_under_one_nccl_rank_replays_its_eager_step(nccl, tmp_path, monkeypatch,
                                                              mode):
    """Under a one-rank NCCL group: the dp step as two graphs around its
    all-reduce; the FSDP2 step as one graph with the trainer's all-reduces
    inside (at one rank the rule shards nothing), and with every tensor
    handed to FSDP2 (its all-gathers and reduce-scatters inside the graph);
    each held against its eager step (``_replayed_against_eager``)."""
    from aid_tpu_torch.parallel import mesh as pmesh
    if mode == "fsdp_every_tensor":
        monkeypatch.setattr(pmesh, "fsdp_shard_dim", lambda shape, n, min_size=0: 0)
    tr = _tiny_trainer(tmp_path, *([] if mode == "dp" else ["exp.mesh.fsdp=True"]))
    assert tr.programs_enabled() and tr.fsdp == (mode != "dp")
    assert sum(d is not None for d in tr.shard_dims) == (
        len(tr.shard_dims) if mode == "fsdp_every_tensor" else 0)
    _replayed_against_eager(tr, graphs=2 if mode == "dp" else 1)


class _Cycle:
    """Refers to itself: only a garbage collection frees it (and its graph)."""

    def __init__(self, graph):
        self.graph, self.me = graph, self


def _dead_graph_in_a_cycle():
    """A weak reference to a captured graph that only a cycle keeps alive."""
    x = torch.ones(1024, device="cuda")
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        x.mul_(2)
    torch.cuda.synchronize()
    return weakref.ref(_Cycle(g))


def test_no_collection_runs_during_a_capture(cuda):
    """``utils.graphs.capture`` turns the collector off while it captures
    and back on after: a program that a cycle keeps alive is not freed in
    the middle of another program's capture."""
    from aid_tpu_torch.utils import graphs
    dead, seen = _dead_graph_in_a_cycle(), []

    def fn():
        seen.append(gc.isenabled())
        return torch.full((8,), 3.0, device="cuda") * 2

    g, out, launches, peak = graphs.capture(fn, graphs.capture_stream("cuda"), what="a probe")
    assert seen == [False] and gc.isenabled() and dead() is not None
    assert launches["fused_adaln"] == (0, 0) and all(n == (0, 0) for n in launches.values())
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, torch.full((8,), 6.0, device="cuda")) and peak > 0
    gc.collect()
    assert dead() is None


def test_a_graph_freed_inside_a_capture_breaks_it(cuda):
    """Why no collection may run during a capture: freeing a graph (here
    by a collection, as an automatic one would) while another is being
    captured makes that capture fail."""
    dead = _dead_graph_in_a_cycle()
    y = torch.ones(8, device="cuda")
    g = torch.cuda.CUDAGraph()
    with pytest.raises(Exception, match="captur"):
        with torch.cuda.graph(g):
            y.mul_(2)
            gc.collect()
            y.mul_(2)
    assert dead() is None
    torch.cuda.synchronize()
    z = torch.ones(8, device="cuda") * 2
    assert float(z.sum()) == 16.0


def _replay_ms(replay):
    """The span between CUDA events around one call of ``replay``."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def test_tiny_programs_read_their_phase_marks_after_a_replay(cuda, tmp_path):
    """The phase marks a capture records are written by every replay, with no
    host synchronisation: after a run the sampler program's body graph reads
    its step and its two denoiser forwards, the trainer's step graph its
    forward, backward and update, each positive; the forwards plus the rest
    of the step are the step, and the step is within 1% of the replay's own
    span between CUDA events around it."""
    import numpy as np

    from aid_tpu_torch import setup as tsetup
    from aid_tpu_torch.sampling import heun
    from aid_tpu_torch.utils import trace
    from aid_tpu_torch.utils.config import compose

    args = compose(overrides=TINY_SAMPLER)
    net = tsetup.setup_network(args, device="cuda", seed=0)
    s = tsetup.setup_sampler(args, net, tsetup.setup_diff_parameters(args))
    x = torch.randn(2, 2048, generator=cuda, device="cuda") * 0.1
    prior, churn = heun.draw_noise((2, 2048), s.cfg.T, cuda, "cuda")
    _task_call(s, "inpainting", x, None, dict(prior=prior, churn=churn))
    (prog,) = s._programs.values()
    assert prog.report()["warm_up_s"] > 0 and prog.report()["graph_capture_s"] > 0
    body = prog.marks["body"]
    outer = _replay_ms(lambda: prog._step("body"))
    latest = max((g for g in trace.snapshot()["marks"] if g["graph"] == "heun.body"),
                 key=lambda g: g["last"])
    marks = latest["marks"]
    assert latest["last"] == body.last and latest["replays"] == s.cfg.T
    assert sorted(n for n, _ in marks) == ["heun.denoise", "heun.denoise", "heun.step"]
    step = sum(ms for n, ms in marks if n == "heun.step")
    forwards = [ms for n, ms in marks if n == "heun.denoise"]
    assert all(ms > 0 for ms in forwards) and sum(forwards) < step
    assert abs(step - outer) <= 0.01 * outer, (step, outer)

    tr = _tiny_trainer(tmp_path)
    tr.init_state()
    audio = (np.random.default_rng(0).standard_normal((4, 4400)) * 0.1).astype(np.float32)
    fs = np.array([44100, 48000, 44100, 48000])
    tr.train_step(audio, fs)
    (sp,) = tr._step_programs.values()
    outer = _replay_ms(sp.graphs[0].replay)
    phases = {}
    for n, ms in sp.marks.read():
        phases[n] = phases.get(n, 0.0) + ms
    assert sorted(phases) == ["train.backward", "train.forward", "train.update"]
    assert all(ms > 0 for ms in phases.values())
    assert abs(sum(phases.values()) - outer) <= 0.01 * outer, (phases, outer)
