"""The sampler's built program (``aid_tpu_torch/sampling/program.py``) on
the CPU, where it runs ``heun_body`` and ``heun_last`` eagerly over its
static buffers.

Tiny U-Net (tests/test_torch_unet.py's configuration, weights carried
across from JAX), T=4, f32: the program equals ``heun_sample`` bit for bit
(inpainting and unconditional, order 1 and 2, data consistency at the end
or every step) and the JAX ``heun_sample`` within ``TRAJ_TOL`` with JAX's
noise injected; the sampler's cache returns the same program for the same
key and a new one for a new shape, a patched fused function or replaced
weights; runs do not alias; ``rid`` mode and a sharded service stay eager;
``precompile``, ``_compiled_for_batch`` and ``_footprint`` read the
program (``memory_bytes`` stubbed: it measures CUDA memory).
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from aid_tpu.diffusion import edm as jedm
from aid_tpu.sampling import degradations as jdegr
from aid_tpu.sampling import heun as jheun
from aid_tpu.serving import InpaintingService as JaxService
from aid_tpu_torch.diffusion import edm as tedm
from aid_tpu_torch.ops import fused_adaln as fa
from aid_tpu_torch.sampling import degradations as tdegr
from aid_tpu_torch.sampling import heun as theun
from aid_tpu_torch.sampling.program import HeunProgram
from aid_tpu_torch.sampling.sampler import Sampler
from aid_tpu_torch.serving import InpaintingService
from aid_tpu_torch.utils.config import compose
from tests.test_torch_sampler import P, T_STEPS, TRAJ_TOL, _jax_noise, _problem, nets  # noqa: F401
from tests.test_torch_serving import TINY
from tests.test_torch_unet import jax_model, rel_err
from tests.torch_threads import one_torch_thread  # noqa: F401

TP = tedm.EDMParams(**P)


def _denoise(net):
    return lambda x, t: tedm.denoiser(TP, net, x, t.reshape(1, 1).expand(x.shape[0], 1))


def _noise(shape, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return theun.draw_noise(shape, T_STEPS, gen)


def _inputs(task, seed=2):
    y, mask = _problem(seed)
    y, mask = np.concatenate([y, 0.5 * y]), np.concatenate([mask, mask[:, ::-1]])
    smooth = tdegr.make_smooth_mask(mask, 50)
    return (torch.from_numpy(y), torch.from_numpy(mask), torch.from_numpy(smooth)) \
        if task == "inpainting" else (None, None, None)


def _program(net, task, cfg, shape):
    dtypes = {k: torch.float32 for k in ("x", "z", "y", "mask", "smooth")}
    return HeunProgram(task, TP, cfg, _denoise(net), shape, dtypes, "cpu",
                       hpf=net.cqt.apply_hpf_DC)


def _eager(net, task, cfg, shape, prior, churn, y, mask, smooth):
    if task == "unconditional":
        score = theun.make_score_fn(TP, cfg, _denoise(net), hpf=net.cqt.apply_hpf_DC)
        return theun.heun_sample(shape, TP, cfg, score, prior=prior, churn=churn)
    proj = tdegr.inpainting_projector(y, smooth)
    score = theun.make_score_fn(TP, cfg, _denoise(net), y=y, degradation=tdegr.time_mask(mask),
                                proj=proj, hpf=net.cqt.apply_hpf_DC)
    return theun.heun_sample(shape, TP, cfg, score, proj_end=proj, prior=prior, churn=churn)


@pytest.mark.parametrize("dc_end", [False, True])
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("task", ["inpainting", "unconditional"])
def test_program_equals_heun_sample_bit_for_bit(nets, task, order, dc_end):
    _, net = nets
    cfg = theun.SamplerConfig(T=T_STEPS, order=order, data_consistency=not dc_end,
                              data_consistency_end=dc_end)
    y, mask, smooth = _inputs(task)
    shape = (2, y.shape[1]) if y is not None else (2, 2048)
    prior, churn = _noise(shape)
    got = _program(net, task, cfg, shape).run(prior, churn, y, mask, smooth)
    ref = _eager(net, task, cfg, shape, prior, churn, y, mask, smooth)
    assert torch.isfinite(ref).all()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("task", ["inpainting", "unconditional"])
def test_program_matches_jax(nets, task):
    """The program route against the JAX ``heun_sample`` (guided, order 2),
    JAX's threefry noise recomputed and injected."""
    params, net = nets
    y, mask = _problem(2)
    smooth = tdegr.make_smooth_mask(mask, 50)
    m = jax_model("tanh")
    jp = jedm.EDMParams(**P)
    cfg_j = jheun.SamplerConfig(T=T_STEPS)

    def run_jax(params, key):
        def denoise(x, t):
            sig = jnp.broadcast_to(jnp.asarray(t, jnp.float32), (x.shape[0], 1))
            return jedm.denoiser(jp, lambda a, c: m.apply(params, a, c), x, sig)
        if task == "unconditional":
            score = jheun.make_score_fn(jp, cfg_j, denoise, hpf=m.cqt.apply_hpf_DC)
            return jheun.heun_sample(key, y.shape, jp, cfg_j, score)[0]
        proj = jdegr.inpainting_projector(jnp.asarray(y), jnp.asarray(smooth))
        score = jheun.make_score_fn(jp, cfg_j, denoise, y=jnp.asarray(y),
                                    degradation=jdegr.time_mask(jnp.asarray(mask)),
                                    proj=proj, hpf=m.cqt.apply_hpf_DC)
        return jheun.heun_sample(key, y.shape, jp, cfg_j, score, proj_end=proj)[0]

    key = jax.random.PRNGKey(11)
    ref = np.asarray(jax.jit(run_jax)(params, key))
    prior, churn = (torch.from_numpy(a) for a in _jax_noise(key, y.shape, T_STEPS))
    prog = _program(net, task, theun.SamplerConfig(T=T_STEPS), y.shape)
    args = (torch.from_numpy(y), torch.from_numpy(mask), torch.from_numpy(smooth)) \
        if task == "inpainting" else ()
    got = prog.run(prior, churn, *args)
    assert np.isfinite(ref).all()
    assert rel_err(got.numpy(), ref) < TRAJ_TOL


# ------------------------------------------------------------ the sampler


@pytest.fixture
def sampler(nets):
    args = compose(overrides=["tester.T=3", "exp.audio_len=2048"])
    return Sampler(nets[1], tedm.EDM(args), args)


def _request(rows=2, seed=4):
    rng = np.random.default_rng(seed)
    mask = np.ones((rows, 2048), np.float32)
    mask[:, 700:1100] = 0.0
    y = (rng.standard_normal((rows, 2048)) * 0.1).astype(np.float32) * mask
    return torch.from_numpy(y), torch.from_numpy(mask)


def test_sampler_programs_equal_heun_sample(sampler):
    """predict_inpainting and predict_unconditional through the program,
    against heun_sample with the same generator's draws."""
    y, mask = _request()
    got = sampler.predict_inpainting(y, mask, generator=torch.Generator().manual_seed(5))
    assert len(sampler._programs) == 1
    smooth = torch.from_numpy(tdegr.make_smooth_mask(mask.numpy(), sampler.hann_size))
    proj = tdegr.inpainting_projector(y, smooth)
    score = theun.make_score_fn(sampler.p, sampler.cfg, sampler._denoise, y=y,
                                degradation=tdegr.time_mask(mask), proj=proj,
                                hpf=sampler._hpf())
    ref = theun.heun_sample(tuple(y.shape), sampler.p, sampler.cfg, score, proj_end=proj,
                            generator=torch.Generator().manual_seed(5), device="cpu")
    assert torch.equal(got, ref)
    got = sampler.predict_unconditional((1, 2048), generator=torch.Generator().manual_seed(6))
    score = theun.make_score_fn(sampler.p, sampler.cfg, sampler._denoise, hpf=sampler._hpf())
    ref = theun.heun_sample((1, 2048), sampler.p, sampler.cfg, score,
                            generator=torch.Generator().manual_seed(6), device="cpu")
    assert torch.equal(got, ref) and len(sampler._programs) == 2


def test_same_key_same_program(sampler):
    y, mask = _request()
    prog = sampler.compile_inpainting(y, mask)
    assert sampler.compile_inpainting(y, mask) is prog
    sampler.predict_inpainting(y, mask, generator=torch.Generator().manual_seed(1))
    assert list(sampler._programs.values()) == [prog]


@pytest.mark.parametrize("change", ["shape", "fused_function", "new_weights",
                                    "weights_loaded_in_place"])
def test_a_new_key_builds_a_new_program(sampler, monkeypatch, change):
    y, mask = _request()
    prog = sampler.compile_inpainting(y, mask)
    net = sampler.model
    if change == "shape":
        y, mask = _request(rows=1)
    elif change == "fused_function":
        monkeypatch.setattr(fa, "norm_adaln_gelu", fa.norm_adaln_gelu_plain)
    elif change == "new_weights":
        w = net.init_conv.weight if hasattr(net, "init_conv") else next(net.parameters())
        monkeypatch.setattr(w, "data", w.data.clone())
    else:
        sd = {k: v.clone() for k, v in net.state_dict().items()}
        net.load_state_dict(sd)
    new = sampler.compile_inpainting(y, mask)
    assert new is not prog
    if change == "shape":
        assert len(sampler._programs) == 2        # both shapes cached
    elif change == "fused_function":
        assert len(sampler._programs) == 2        # kernel and plain programs side by side
    else:
        assert list(sampler._programs.values()) == [new]   # the stale one dropped


def test_runs_do_not_alias(sampler):
    y, mask = _request()
    a = sampler.predict_inpainting(y, mask, generator=torch.Generator().manual_seed(1))
    kept = a.clone()
    y2, mask2 = _request(seed=9)
    b = sampler.predict_inpainting(y2, mask2, generator=torch.Generator().manual_seed(2))
    assert len(sampler._programs) == 1
    assert a.data_ptr() != b.data_ptr() and torch.equal(a, kept) and not torch.equal(a, b)
    prog = next(iter(sampler._programs.values()))
    assert b.data_ptr() != prog.x.data_ptr()


def test_rid_mode_stays_eager(nets):
    args = compose(overrides=["tester.T=3", "exp.audio_len=2048"])
    s = Sampler(nets[1], tedm.EDM(args), args, rid=True)
    y, mask = _request()
    x, rec = s.predict_inpainting(y, mask, generator=torch.Generator().manual_seed(1))
    assert rec.xt.shape == (3, 2, 2048) and not s._programs and not s.programs_enabled()
    with pytest.raises(ValueError, match="record"):
        HeunProgram("inpainting", s.p, s.cfg, s._denoise, (2, 2048),
                    dict.fromkeys(("x", "z", "y", "mask", "smooth"), torch.float32), "cpu")


def test_a_sharded_service_stays_eager(tmp_path):
    svc = InpaintingService.from_config(TINY, device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            rank=0, world_size=1)
    try:
        svc.shard()
        assert not svc.sampler.programs_enabled()
        audio = (np.random.default_rng(2).standard_normal(3000) * 0.1).astype(np.float32)
        mask = np.ones(3000, np.float32)
        mask[1000:1200] = 0.0
        out = svc.inpaint(audio, mask, 4096, seed=1)
        svc.precompile()
        assert np.isfinite(out).all() and not svc.sampler._programs
    finally:
        dist.destroy_process_group()
    assert svc.sampler.programs_enabled()


def test_precompile_builds_the_max_batch_program():
    """precompile builds [max_batch, L] first, then each smaller row count;
    rounds of two rows and of one row then run those programs."""
    svc = InpaintingService.from_config(TINY, device="cpu")
    svc.precompile()
    progs = list(svc.sampler._programs.values())
    L = int(svc.args.exp.audio_len)
    assert svc.max_batch == 2 and [p.shape for p in progs] == [(2, L), (1, L)]
    assert svc._compiled_for_batch(svc.max_batch) is progs[0]
    assert svc._compiled_for_batch(1) is progs[1]
    assert all(p.task == "inpainting" and p.launches_per_run() == 0
               and p.report()["graphs"] is False for p in progs)
    audio = (np.random.default_rng(3).standard_normal(2 * L) * 0.1).astype(np.float32)
    mask = np.ones(2 * L, np.float32)
    mask[300:340] = mask[2500:2540] = mask[3800:3840] = 0.0     # rounds of 2, then 1
    svc.inpaint(audio, mask, int(svc.args.exp.sample_rate), seed=1)
    assert list(svc.sampler._programs.values()) == progs


@pytest.mark.parametrize("max_batch,limit_gib", [(1, 80), (2, 80), (8, 3)])
def test_footprint_reads_memory_bytes(monkeypatch, max_batch, limit_gib):
    """_footprint is the weights plus the program's memory_bytes (stubbed:
    on the CPU it raises); autotune gives the JAX service's answer for the
    same footprints; a probe wider than max_batch is dropped."""
    per_row, fixed = 3 * 2 ** 28, 2 ** 30
    monkeypatch.setattr(HeunProgram, "memory_bytes",
                        lambda self: fixed + per_row * self.shape[0])
    svc = InpaintingService.from_config(TINY, device="cpu", max_batch=max_batch)
    weights = sum(p.numel() * p.element_size() for p in svc.network.parameters())
    assert svc._footprint(1) == weights + fixed + per_row
    assert len(svc.sampler._programs) == 1
    assert svc._footprint(2) == weights + fixed + 2 * per_row
    assert len(svc.sampler._programs) == (0 if max_batch < 2 else 2)
    j = JaxService(args=svc.args, bundle=None, sampler=None, max_batch=max_batch)
    foot = {n: weights + fixed + per_row * n for n in (1, 2)}
    j._compiled_for_batch = lambda n, seed=0: SimpleNamespace(
        memory_analysis=lambda: SimpleNamespace(argument_size_in_bytes=foot[n],
                                                output_size_in_bytes=0, temp_size_in_bytes=0))
    limit = limit_gib * 2 ** 30
    assert svc.autotune_max_batch(limit_bytes=limit) == j.autotune_max_batch(limit_bytes=limit)
    assert svc.max_batch == j.max_batch


def test_program_checks_its_inputs(nets):
    _, net = nets
    cfg = theun.SamplerConfig(T=T_STEPS)
    prog = _program(net, "inpainting", cfg, (2, 2048))
    prior, churn = _noise((2, 2048))
    y, mask, smooth = _inputs("inpainting")
    with pytest.raises(ValueError, match="noise shapes"):
        prog.run(prior[:1], churn, y, mask, smooth)
    with pytest.raises(ValueError, match="mask"):
        prog.run(prior, churn, y, None, smooth)
    with pytest.raises(ValueError, match="task"):
        _program(net, "bwe", cfg, (2, 2048))
    with pytest.raises(RuntimeError, match="CUDA"):
        prog.memory_bytes()
    assert dataclasses.asdict(prog.cfg) == dataclasses.asdict(cfg)


@pytest.mark.parametrize("how", ["release_programs", "drop_the_sampler"])
def test_programs_are_freed_without_a_garbage_collection(nets, how):
    """A program holds the model, not its sampler: releasing the programs or
    dropping the sampler frees them (and, on the card, their graph pool)
    by reference counting alone."""
    import gc
    import weakref
    args = compose(overrides=["tester.T=3", "exp.audio_len=2048"])
    s = Sampler(nets[1], tedm.EDM(args), args)
    ref = weakref.ref(s.compile_inpainting(*_request()))
    gc.disable()
    try:
        if how == "release_programs":
            s.release_programs()
        else:
            del s
        assert ref() is None
    finally:
        gc.enable()


def test_the_training_demo_releases_its_program():
    """The trainer's demo loads new EMA weights every time, which drops the
    program built over the last ones: the tester releases it at once, so
    training does not hold its buffers (and, on the card, its graph pool)
    between demos."""
    from aid_tpu_torch import setup as tsetup
    args = compose(overrides=TINY + ["tester.unconditional.num_samples=1",
                                     "tester.unconditional.audio_len=2048"])
    net = tsetup.setup_network(args, device="cpu", trainable=True)
    t = tsetup.setup_tester(args, network=net, diff_params=tsetup.setup_diff_parameters(args),
                            device="cpu", in_training=True)
    built = []
    orig = t.sampler._cached_program

    def cached(key, build):
        built.append(key)
        return orig(key, build)

    t.sampler._cached_program = cached
    ema = {k: v.detach() * 0.5 for k, v in net.named_parameters()}
    x = t.sample_unconditional_ema(ema)
    assert x.shape == (1, 2048) and np.isfinite(x).all()
    assert len(built) == 1 and not t.sampler._programs
