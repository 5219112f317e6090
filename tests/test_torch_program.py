"""The sampler's built program (``aid_tpu_torch/sampling/program.py``) on
the CPU, where it runs ``heun_body`` and ``heun_last`` eagerly over its
static buffers.

Tiny U-Net (tests/test_torch_unet.py's configuration, weights carried
across from JAX), T=4, f32: the program of each of the seven tasks, with
and without ``rid`` recording, equals ``heun_sample`` over the same
operators built on the request's tensors bit for bit (inpainting and
unconditional also at order 1 and with data consistency at the end);
inpainting and unconditional programs equal the JAX ``heun_sample``, and
the five other tasks' programs the JAX ``Sampler``'s compiled programs
(tests/test_torch_sampler_tasks.py's stand-in net), within ``TRAJ_TOL``
with JAX's noise injected. The sampler's cache returns the same program
for the same key and a new one for a new shape, a new BWE filter, a
patched fused function or replaced weights, but not for a new mask, clip
value or spectral mask; runs do not alias; under a process group a dp
mesh's service runs its programs and a network that communicates (tp, cp)
runs eagerly; ``precompile``, ``_compiled_for_batch`` and ``_footprint`` read the
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
from aid_tpu_torch.sampling import program as tprog
from aid_tpu_torch.sampling.program import HeunProgram
from aid_tpu_torch.sampling.sampler import Sampler
from aid_tpu_torch.serving import InpaintingService
from aid_tpu_torch.utils import graphs
from aid_tpu_torch.utils.config import compose
from tests import test_torch_sampler_tasks as tasks_vs_jax
from tests.test_torch_sampler import P, T_STEPS, TRAJ_TOL, _jax_noise, _problem, nets  # noqa: F401
from tests.test_torch_serving import TINY
from tests.test_torch_unet import FS, jax_model, rel_err
from tests.torch_threads import one_torch_thread  # noqa: F401

TP = tedm.EDMParams(**P)
STFT = SimpleNamespace(n_fft=256, hop_length=64, win_length=256)
TASKS = ["inpainting", "unconditional", "spectrogram_inpainting", "bwe", "declipping",
         "phase_retrieval", "compsens"]


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


def _spectral_mask(L):
    frames = 1 + (L + STFT.n_fft - L % STFT.n_fft) // STFT.hop_length
    m = torch.ones(STFT.n_fft // 2 + 1, frames)
    m[10:40, 6:14] = 0.0
    return m


def _case(task, cfg, shape=(2, 2048)):
    """(the port's Task, the config it runs under, its inputs, and the
    eager reference's operators (observation, degradation, projection)
    built on the inputs themselves, independently of the Task)."""
    x = torch.from_numpy((np.random.default_rng(5).standard_normal(shape) * 0.1)
                         .astype(np.float32))
    generic = dataclasses.replace(cfg, guidance_eps="generic")
    if task in ("inpainting", "unconditional"):
        if task == "unconditional":
            return tprog.unconditional(), cfg, {}, (None, None, None)
        y, mask, smooth = _inputs(task)
        proj = tdegr.inpainting_projector(y, smooth)
        return (tprog.inpainting(), cfg, dict(y=y, mask=mask, smooth=smooth),
                (y, tdegr.time_mask(mask), proj))
    if task == "spectrogram_inpainting":
        m = _spectral_mask(shape[1])
        apply = tdegr.spectral_mask(m, STFT)
        y = apply(x)
        return (tprog.spectrogram_inpainting(STFT), cfg, dict(y=y, mask_FT=m),
                (y, apply, tdegr.spectral_projector(y, apply)))
    if task == "bwe":
        lpf = tdegr.firwin_lowpass(64, 400.0, FS)
        y = lpf(x)
        return (tprog.bwe("firwin", 64, 400.0, FS), generic, dict(y=y),
                (y, lpf, tdegr.spectral_projector(y, lpf)))
    if task == "declipping":
        cv = tdegr.clip_value_from_sdr(x, 3.0)
        y = tdegr.hard_clip(cv)(x)
        return (tprog.declipping(), generic, dict(y=y, clip_value=cv),
                (y, tdegr.hard_clip(cv), None))
    if task == "phase_retrieval":
        mag = tdegr.stft_magnitude(STFT)
        y = mag(x)
        return tprog.phase_retrieval(shape, STFT), generic, dict(y_mag=y), (y, mag, None)
    mask = tdegr.compsens_mask(shape, 20.0, torch.Generator().manual_seed(8))
    cs = dataclasses.replace(generic, data_consistency=False, data_consistency_end=False)
    return tprog.compsens(), cs, dict(y=x * mask, mask=mask), (x * mask, tdegr.time_mask(mask),
                                                               None)


def _program(net, task, cfg, inputs, shape=(2, 2048)):
    buffers = {"x": (shape, torch.float32), "z": (shape, torch.float32),
               **graphs.specs(inputs)}
    return HeunProgram(task, TP, cfg, _denoise(net), buffers, "cpu", hpf=net.cqt.apply_hpf_DC)


def _eager(net, cfg, shape, prior, churn, ops):
    y, degradation, proj = ops
    score = theun.make_score_fn(TP, cfg, _denoise(net), y=y, degradation=degradation,
                                proj=proj, hpf=net.cqt.apply_hpf_DC)
    return theun.heun_sample(shape, TP, cfg, score, proj_end=proj, prior=prior, churn=churn)


CASES = ([(task, rid, 2, False) for task in TASKS for rid in (False, True)]
         + [(task, False, order, dc_end) for task in ("inpainting", "unconditional")
            for order, dc_end in ((1, False), (1, True), (2, True))])


@pytest.mark.parametrize("task,rid,order,dc_end", CASES,
                         ids=[f"{t}-{'rid' if r else 'x'}-order{o}-{'end' if e else 'always'}"
                              for t, r, o, e in CASES])
def test_program_equals_heun_sample_bit_for_bit(nets, task, rid, order, dc_end):
    """Each task's program against ``heun_sample`` on the same noise: x and,
    with ``rid``, every Record field [T, B, L]."""
    _, net = nets
    cfg = theun.SamplerConfig(T=T_STEPS, order=order, data_consistency=not dc_end,
                              data_consistency_end=dc_end, record=rid)
    t, cfg, inputs, ops = _case(task, cfg)
    shape = (2, 2048)
    prior, churn = _noise(shape)
    prog = _program(net, t, cfg, inputs)
    assert prog.task == task
    got = prog.run(prior, churn, **inputs)
    ref = _eager(net, cfg, shape, prior, churn, ops)
    if rid:
        (got, got_rec), (ref, ref_rec) = got, ref
        assert got_rec._fields == ref_rec._fields
        for field in ref_rec._fields:
            g, r = getattr(got_rec, field), getattr(ref_rec, field)
            assert g.shape == r.shape == (T_STEPS,) + shape, field
            assert torch.equal(g, r), field
        assert prog.static_bytes() >= 6 * T_STEPS * 2 * 2048 * 4
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
    inputs = dict(y=torch.from_numpy(y), mask=torch.from_numpy(mask),
                  smooth=torch.from_numpy(smooth)) if task == "inpainting" else {}
    t = tprog.inpainting() if task == "inpainting" else tprog.unconditional()
    prog = _program(net, t, theun.SamplerConfig(T=T_STEPS), inputs, shape=y.shape)
    got = prog.run(prior, churn, **inputs)
    assert np.isfinite(ref).all()
    assert rel_err(got.numpy(), ref) < TRAJ_TOL


@pytest.fixture(scope="module")
def stand_ins():
    return tasks_vs_jax.JaxStandIn(), tasks_vs_jax.TorchStandIn()


JAX_KEYS = {"spectrogram_inpainting": ("spec_inpaint",),
            "bwe_firwin": ("bwe", "firwin", 400.0, FS, 64),
            "declipping": ("declip",), "phase_retrieval": ("phase", (1, 2048)),
            "compsens": ("compsens",)}


@pytest.mark.parametrize("task", list(JAX_KEYS))
def test_task_program_matches_the_jax_program(stand_ins, task):
    """The port sampler's program of each task against the JAX ``Sampler``'s
    compiled program of the same task (its ``_cached_program``), the same
    inputs and JAX's noise injected, within ``TRAJ_TOL``; the port built
    one program, under the JAX package's key."""
    js, ts = tasks_vs_jax._samplers(stand_ins)
    ref, got = tasks_vs_jax._run_task(js, ts, task, jax.random.PRNGKey(11))
    assert ref.shape == got.shape == (1, 2048) and np.isfinite(ref).all()
    assert rel_err(got, ref) < TRAJ_TOL
    assert [k[0][0] for k in ts._programs] == [JAX_KEYS[task]]
    assert len(js._programs) == 1 and list(js._programs)[0][0] == JAX_KEYS[task][0]


def _task_call(ts, change, value, seed=1):
    """One task call of the stand-in sampler whose ``change`` takes ``value``."""
    x = tasks_vs_jax._signal(seed)
    xt = torch.from_numpy(x)
    gen = torch.Generator().manual_seed(seed)
    if change == "bwe_fc":
        lpf = tdegr.bwe_lowpass("firwin", 64, value, tasks_vs_jax.FS)
        return ts.predict_bwe(lpf(xt), value, tasks_vs_jax.FS, order=64, generator=gen)
    if change == "clip_value":
        return ts.predict_declipping(torch.clamp(xt, -value, value), value, generator=gen)
    stft = ts.args.tester.spectrogram_inpainting.stft
    m = torch.from_numpy(tasks_vs_jax._spectral_mask(stft))
    m[value:value + 20] = 0.0
    return ts.predict_spectrogram_inpainting(tdegr.spectral_mask(m, stft)(xt), m,
                                             generator=gen)


@pytest.mark.parametrize("change,values,programs", [
    ("bwe_fc", (400.0, 800.0), 2),          # the filter is static: a new program
    ("clip_value", (0.05, 0.08), 1),        # traced in JAX: a buffer here
    ("mask_FT", (20, 60), 1),
])
def test_task_cache_follows_the_jax_keys(stand_ins, change, values, programs):
    _, ts = tasks_vs_jax._samplers(stand_ins)
    outs = [_task_call(ts, change, v) for v in values]
    assert len(ts._programs) == programs
    assert not torch.equal(outs[0], outs[1]) and all(torch.isfinite(o).all() for o in outs)
    again = _task_call(ts, change, values[0])        # the first value once more
    assert len(ts._programs) == programs and torch.equal(again, outs[0])


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
    """(Named when ``rid`` ran eagerly.) ``rid`` recording runs through a
    program now: the sampler builds one, and its x and Record equal
    ``heun_sample``'s bit for bit on the same noise."""
    args = compose(overrides=["tester.T=3", "exp.audio_len=2048"])
    s = Sampler(nets[1], tedm.EDM(args), args, rid=True)
    y, mask = _request()
    x, rec = s.predict_inpainting(y, mask, generator=torch.Generator().manual_seed(1))
    assert rec.xt.shape == (3, 2, 2048) and s.programs_enabled()
    (prog,) = s._programs.values()
    assert prog.cfg.record and prog.records is not None
    smooth = torch.from_numpy(tdegr.make_smooth_mask(mask.numpy(), s.hann_size))
    proj = tdegr.inpainting_projector(y, smooth)
    score = theun.make_score_fn(s.p, s.cfg, s._denoise, y=y, degradation=tdegr.time_mask(mask),
                                proj=proj, hpf=s._hpf())
    ref_x, ref = theun.heun_sample(tuple(y.shape), s.p, s.cfg, score, proj_end=proj,
                                   generator=torch.Generator().manual_seed(1), device="cpu")
    assert torch.equal(x, ref_x)
    assert all(torch.equal(getattr(rec, f), getattr(ref, f)) for f in ref._fields)
    kept = rec.denoised.clone()          # a second run writes the program's buffers again
    s.predict_inpainting(y, mask, generator=torch.Generator().manual_seed(2))
    assert torch.equal(rec.denoised, kept) and rec.denoised.data_ptr() != \
        prog.records.denoised.data_ptr()


@pytest.fixture
def one_rank_group(tmp_path):
    """A one-rank gloo process group for the test's duration."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _host_request():
    """A 3000-sample request at 4096 Hz with one 200-sample gap."""
    audio = (np.random.default_rng(2).standard_normal(3000) * 0.1).astype(np.float32)
    mask = np.ones(3000, np.float32)
    mask[1000:1200] = 0.0
    return audio, mask


def test_a_dp_sharded_service_serves_through_its_programs(one_rank_group):
    """Under a process group a dp mesh's trajectories make no collective:
    the rank's rows run through its program, and at one rank the answer is
    the unsharded service's bit for bit."""
    audio, mask = _host_request()
    ref = InpaintingService.from_config(TINY, device="cpu").inpaint(audio, mask, 4096, seed=1)
    svc = InpaintingService.from_config(TINY, device="cpu").shard()
    assert svc.sampler.programs_enabled()
    out = svc.inpaint(audio, mask, 4096, seed=1)
    assert np.array_equal(out, ref)
    (prog,) = svc.sampler._programs.values()
    assert prog.task == "inpainting" and prog.shape[0] == 1


def test_precompile_under_a_dp_mesh_builds_the_rank_row_counts(one_rank_group):
    """After ``shard`` precompile builds this rank's programs, from its rows
    of max_batch down to 1."""
    svc = InpaintingService.from_config(TINY, device="cpu", max_batch=3).shard()
    svc.precompile()
    L = int(svc.args.exp.audio_len)
    assert [p.shape for p in svc.sampler._programs.values()] == [(3, L), (2, L), (1, L)]


@pytest.mark.parametrize("split", ["tp", "cp"])
def test_a_network_that_communicates_runs_eagerly(one_rank_group, split):
    """A network split over tp ranks, or context-parallel under an installed
    cp mesh, makes collectives inside every score: its trajectories run
    eagerly, by rule, and so do its training steps; a cp flag without a cp
    mesh changes nothing."""
    from aid_tpu_torch.parallel import mesh as pmesh
    from aid_tpu_torch.parallel import ring_attention as ring
    from aid_tpu_torch.training.trainer import Trainer
    svc = InpaintingService.from_config(TINY, device="cpu")
    if split == "tp":
        layer = next(m for m in svc.network.modules() if hasattr(m, "tp_group"))
        layer.tp_group = dist.group.WORLD
    else:
        for m in svc.network.modules():
            if hasattr(m, "context_parallel"):
                m.context_parallel = True
        assert svc.sampler.programs_enabled()
        ring.set_cp_mesh(ring.make_cp_mesh(1, device_type="cpu"))
    try:
        assert pmesh.communicates(svc.network) and not svc.sampler.programs_enabled()
        trainer = SimpleNamespace(net=svc.network, fsdp=False, mesh=None)
        assert not Trainer.programs_enabled(trainer)
        out = svc.inpaint(*_host_request(), 4096, seed=1)
        assert np.isfinite(out).all() and not svc.sampler._programs
    finally:
        ring.set_cp_mesh(None)
    assert svc.sampler.programs_enabled() == (split == "cp")


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
    y, mask, smooth = _inputs("inpainting")
    inputs = dict(y=y, mask=mask, smooth=smooth)
    prog = _program(net, tprog.inpainting(), cfg, inputs)
    prior, churn = _noise((2, 2048))
    with pytest.raises(ValueError, match="noise shapes"):
        prog.run(prior[:1], churn, **inputs)
    with pytest.raises(ValueError, match="mask"):
        prog.run(prior, churn, y=y, mask=None, smooth=smooth)
    with pytest.raises(ValueError, match="mask"):
        prog.run(prior, churn, y=y, mask=mask[:1], smooth=smooth)
    with pytest.raises(ValueError, match="inputs"):
        prog.run(prior, churn, y=y, mask=mask)
    with pytest.raises(ValueError, match="buffers"):
        _program(net, tprog.bwe("firwin", 64, 400.0, FS), cfg, inputs)
    with pytest.raises(RuntimeError, match="CUDA"):
        prog.memory_bytes()
    assert dataclasses.asdict(prog.cfg) == dataclasses.asdict(cfg)


def _tiny_tester(tmp_path, in_training):
    from aid_tpu_torch import setup as tsetup
    args = compose(overrides=TINY + ["tester.unconditional.num_samples=1",
                                     "tester.unconditional.audio_len=2048",
                                     f"model_dir={tmp_path}"])
    net = tsetup.setup_network(args, device="cpu", trainable=in_training)
    rng = np.random.default_rng(6)
    test_set = [((rng.standard_normal(2048) * 0.1).astype(np.float32), 4096, "piece.wav")]
    return tsetup.setup_tester(args, network=net, diff_params=tsetup.setup_diff_parameters(args),
                               test_set=test_set, device="cpu", in_training=in_training)


@pytest.mark.parametrize("how", ["release_programs", "drop_the_sampler", "training_demo",
                                 "test_inpainting_kernel_and_plain"])
def test_programs_are_freed_without_a_garbage_collection(nets, how, tmp_path, monkeypatch):
    """A program holds the model, not its sampler, and the tester holds no
    cycle: releasing the programs, dropping the sampler, or dropping a
    tester after the training demo or after ``test_inpainting`` with the
    kernel and then the plain version frees every program (and, on the
    card, its graph pool) by reference counting alone. A program freed by
    the collector instead could be freed inside another program's capture."""
    import gc
    import weakref
    built = []
    init = HeunProgram.__init__

    def tracked(self, *a, **k):
        built.append(weakref.ref(self))
        init(self, *a, **k)

    monkeypatch.setattr(HeunProgram, "__init__", tracked)
    gc.collect()
    gc.disable()
    try:
        if how in ("release_programs", "drop_the_sampler"):
            args = compose(overrides=["tester.T=3", "exp.audio_len=2048"])
            owner = Sampler(nets[1], tedm.EDM(args), args)
            owner.compile_inpainting(*_request())
            if how == "release_programs":
                owner.release_programs()
        elif how == "training_demo":
            owner = _tiny_tester(tmp_path, in_training=True)
            ema = {k: v.detach() * 0.5 for k, v in owner.network.named_parameters()}
            assert np.isfinite(owner.sample_unconditional_ema(ema)).all()
        else:
            owner = _tiny_tester(tmp_path, in_training=False)
            assert owner.test_inpainting(mode="kernel") == ["piece"]
            monkeypatch.setattr(fa, "norm_adaln_gelu", fa.norm_adaln_gelu_plain)
            assert owner.test_inpainting(mode="plain") == ["piece"]
        assert len(built) == {"test_inpainting_kernel_and_plain": 2}.get(how, 1)
        owner = weakref.ref(owner)
        assert owner() is None
        assert all(r() is None for r in built)
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
