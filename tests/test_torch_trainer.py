"""The port's training path against the JAX package's ``Trainer``: training
steps, checkpoints and the ``python -m aid_tpu_torch.train`` entry.

Tiny configuration (3 octaves, 8 bins, 2048 samples, Ns=(8,16,16)), f32 on
the CPU. Both trainers start from the same weights (the JAX init carried
across with ``state_dict_from_flax``) and take the same host batches:
native-rate rows at 44.1 and 48 kHz, so every step resamples on the device.
The JAX trainer's random draws (polarity sign, sigma, noise) are recomputed
from its key schedule and injected into the port.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aid_tpu import setup as asetup
from aid_tpu.diffusion import edm as jedm
from aid_tpu.utils.config import compose as jcompose
from aid_tpu_torch import setup as tsetup
from aid_tpu_torch import train as ttrain
from aid_tpu_torch.data import audio_io
from aid_tpu_torch.utils import checkpoint as ckpt
from aid_tpu_torch.utils.config import compose
from aid_tpu_torch.utils.convert import state_dict_from_flax
from tests.torch_threads import one_torch_thread  # noqa: F401

B, T_NATIVE, L = 4, 4400, 2048
TINY = ["exp.audio_len=2048", f"exp.batch={B}", "exp.total_its=3", "exp.lr_rampup_it=2",
        "exp.ema_rampup=2", "exp.mesh.dp=1", "network.cqt.num_octs=3",
        "network.cqt.bins_per_oct=8", "network.Ns=[8,16,16]", "network.num_dils=[1,1,1]",
        "network.attention_layers=[0,0,1,1]", "network.compute_dtype=float32",
        "network.remat=False", "logging.save_interval=100", "logging.log_interval=1",
        "logging.print_model_summary=False"]
# JAX's step name for a module group -> the first component of the port's
# state-dict names
GROUPS = {"down": "downs", "mid": "middle", "up": "ups", "embedding": "embedding"}


def _jax(tmp, ov):
    ja = jcompose(overrides=list(ov) + [f"model_dir={tmp}/jax"])
    jtr = asetup.setup_trainer(ja, network=asetup.setup_network(ja),
                               diff_params=asetup.setup_diff_parameters(ja))
    jtr.init_state()
    return jtr


def _pair(tmp, extra=()):
    """A JAX trainer and a port trainer on the same config and weights."""
    ov = TINY + list(extra)
    jtr = _jax(tmp, ov)
    return jtr, _port(tmp, ov, state_dict_from_flax(jax.device_get(jtr.state.params)))


def _port(tmp, ov, state_dict=None, sub="torch"):
    ta = compose(overrides=list(ov) + [f"model_dir={tmp}/{sub}"])
    net = tsetup.setup_network(ta, device="cpu", state_dict=state_dict, seed=1,
                               trainable=True)
    tr = tsetup.setup_trainer(ta, network=net, diff_params=tsetup.setup_diff_parameters(ta))
    tr.init_state()
    return tr


def _batch(rng):
    audio = (rng.standard_normal((B, T_NATIVE)) * 0.1).astype(np.float32)
    return audio, np.array([44100, 48000] * (B // 2), np.int64)


def _jax_draws(jtr, n_accum):
    """The draws JAX's next train_step makes: its step key is the second
    half of a split of the trainer key, then (per micro-batch) augmentation
    and loss keys, the loss key split into sigma and noise keys."""
    k = jax.random.split(jtr.key)[1]
    keys = jax.random.split(k, n_accum) if n_accum > 1 else [k]
    Bm = B // n_accum
    out = []
    for key in keys:
        k_aug, k_loss = jax.random.split(key)
        sign = jax.random.bernoulli(jax.random.split(k_aug)[1], 0.5, (Bm, 1))
        k_sigma, k_noise = jax.random.split(k_loss)
        sigma = jedm.sample_ptrain_safe(jtr.p, k_sigma, Bm)
        out.append({"sign": np.where(np.asarray(sign), -1.0, 1.0).astype(np.float32),
                    "sigma": np.asarray(sigma),
                    "noise": np.asarray(jax.random.normal(k_noise, (Bm, L), jnp.float32)
                                        * sigma[:, None])})
    return out


def _port_state(tr):
    return {name: dict(zip(tr.names, [t.detach().clone() for t in ts]))
            for name, ts in (("params", tr.params), ("ema", tr.ema), ("mu", tr.mu),
                             ("nu", tr.nu))}


def _jax_state(jtr):
    s = jax.device_get(jtr.state)
    adam = s.opt_state[1]
    return {"params": state_dict_from_flax(s.params), "ema": state_dict_from_flax(s.ema),
            "mu": state_dict_from_flax(adam.mu), "nu": state_dict_from_flax(adam.nu)}


def _rel_l2(a, b, base=None):
    """|a - b| / |b - base| over all tensors of two state dicts (L2)."""
    num = sum(float((a[n] - b[n]).double().pow(2).sum()) for n in b)
    den = sum(float((b[n] - (0 if base is None else base[n])).double().pow(2).sum())
              for n in b)
    return (num / max(den, 1e-300)) ** 0.5


# Tolerances (f32, both frameworks summing in their own orders):
#   loss and pre-clip gradient norm: 1e-5 relative (observed ~5e-6);
#   Adam moments: 1e-3 relative in L2 over all parameters;
#   the parameter update and the EMA's move: 2e-3 relative in L2 (observed
#     3e-4), and each element within 10% of the largest step: Adam's
#     m / sqrt(v) amplifies the rounding difference of a gradient entry
#     whose terms cancel.
@pytest.mark.parametrize("route", ["program", "eager"])
@pytest.mark.parametrize("extra,skips", [
    ((), ()),
    (("exp.num_accumulation_rounds=2",), ()),
    (("exp.skip_grad_norm=1e-12",), (1, 2, 3)),
    # relative guard: step 1 warms the gnorm EMA, then every step is a spike
    (("exp.skip_grad_factor=1e-3",), (2, 3)),
], ids=["plain", "accumulate2", "skip_grad_norm", "skip_grad_factor"])
def test_train_steps_match_jax(tmp_path, extra, skips, route):
    """Through the step program (``train_step``) and through the eager step
    it captures, each against the JAX trainer."""
    jtr, ttr = _pair(str(tmp_path), extra)
    n_accum = ttr.n_accum
    rng = np.random.default_rng(0)
    p0 = _port_state(ttr)["params"]
    for step in (1, 2, 3):
        audio, fs = _batch(rng)
        draws = _jax_draws(jtr, n_accum)
        before = _port_state(ttr)
        jm = jtr.train_step(audio, fs)
        tm = ttr._train_step(audio, fs, draws, program=route == "program")
        assert ttr.step_programs_built == (route == "program")
        for k in ("loss", "grad_norm", "gnorm_ema"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
        assert float(tm["skipped"]) == float(jm["skipped"]) == float(step in skips)
        assert int(ttr.count) == int(jtr.state.opt_state[1].count)
        assert int(ttr.applied) == int(jtr.state.applied) == step - sum(s <= step for s in skips)
        assert ttr.it == int(jtr.state.it) == step
        got, ref = _port_state(ttr), _jax_state(jtr)
        if step == 1 or step in skips:
            # lr 0 on the first step; a skipped step keeps params and moments
            for n in ttr.names:
                torch.testing.assert_close(got["params"][n], before["params"][n], rtol=0, atol=0)
                if step in skips:
                    for k in ("mu", "nu"):
                        torch.testing.assert_close(got[k][n], before[k][n], rtol=0, atol=0)
        else:
            moved = max(float((ref["params"][n] - p0[n]).abs().max()) for n in ttr.names)
            assert moved > 0
            for k in ("params", "ema"):
                assert _rel_l2(got[k], ref[k], p0) <= 2e-3, k
                assert max(float((got[k][n] - ref[k][n]).abs().max())
                           for n in ttr.names) <= 0.1 * moved, k
        for k in ("mu", "nu"):
            assert _rel_l2(got[k], ref[k]) <= 1e-3, k
        np.testing.assert_array_equal(tm["sigma_bins"][:, 0].numpy(),
                                      np.asarray(jm["sigma_bins"])[:, 0])
        np.testing.assert_allclose(tm["sigma_bins"].numpy(), np.asarray(jm["sigma_bins"]),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(tm["loss_moments"].numpy(), np.asarray(jm["loss_moments"]),
                                   rtol=1e-4)
        jsq = {}
        for k, v in jm["grad_norms_by_module"].items():
            g = GROUPS[k.split("_")[0]]
            jsq[g] = jsq.get(g, 0.0) + float(v) ** 2
        assert set(jsq) == set(tm["grad_norms_by_module"])
        for g, v in tm["grad_norms_by_module"].items():
            np.testing.assert_allclose(float(v), jsq[g] ** 0.5, rtol=1e-3, atol=1e-12,
                                       err_msg=g)


def _steps(tr, rng, n, gen_draws):
    for _ in range(n):
        audio, fs = _batch(rng)
        tr.train_step(audio, fs, gen_draws(rng))


def _numpy_draws(rng):
    sigma = np.exp(rng.uniform(-6, 1, B)).astype(np.float32)
    return [{"sign": np.where(rng.random((B, 1)) < 0.5, -1.0, 1.0).astype(np.float32),
             "sigma": sigma,
             "noise": (rng.standard_normal((B, L)) * sigma[:, None]).astype(np.float32)}]


def _assert_same_state(a, b):
    for k, sa in _port_state(a).items():
        sb = _port_state(b)[k]
        for n in a.names:
            torch.testing.assert_close(sa[n], sb[n], rtol=0, atol=0, msg=f"{k} {n}")
    assert (a.it, int(a.count), int(a.applied), float(a.gnorm_ema)) == \
        (b.it, int(b.count), int(b.applied), float(b.gnorm_ema))


def _metrics_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        return all(_metrics_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


@pytest.mark.parametrize("n_accum", [1, 2])
def test_program_step_equals_the_eager_step_bit_for_bit(tmp_path, n_accum):
    """``train_step`` (the step program: on the CPU the captured function
    run eagerly over its static buffers) against the eager step on the same
    weights, drawing from the trainers' own generators; the third step's
    batch spikes the gradient norm past the relative guardrail, so it is
    skipped. Every metric and every state tensor equal, bit for bit."""
    tmp = str(tmp_path)
    ov = TINY + [f"exp.num_accumulation_rounds={n_accum}", "exp.skip_grad_factor=3.0"]
    prog, eager = _port(tmp, ov, sub="program"), _port(tmp, ov, sub="eager")
    rng = np.random.default_rng(0)
    for step in (1, 2, 3, 4):
        audio, fs = _batch(rng)
        audio = audio * (30.0 if step == 3 else 1.0)
        mp = prog.train_step(audio, fs)
        me = eager._train_step(audio, fs, None, program=False)
        assert _metrics_equal(mp, me), step
        assert float(mp["skipped"]) == float(step == 3)
        _assert_same_state(prog, eager)
    assert torch.equal(prog.gen.get_state(), eager.gen.get_state())
    (p,) = prog._step_programs.values()
    assert prog.step_programs_built == 1 and eager.step_programs_built == 0
    assert p.shapes()["x"] == [n_accum, B // n_accum, L] and not p.graphs


def test_compile_step_leaves_the_state_unchanged(tmp_path):
    """``compile_step`` builds the program ``train_step`` then runs, and
    leaves the parameters, both moments, the EMA, the counters, ``it`` and
    the generator (whose draws fill the build's buffers) as they were; the
    trainer then trains as one that never compiled. The state snapshot that
    undoes the warm-up's update on the card writes the state back exactly."""
    tmp = str(tmp_path)
    tr, ref = _port(tmp, TINY, sub="compiled"), _port(tmp, TINY, sub="ref")
    rng = np.random.default_rng(0)
    _steps(tr, rng, 1, lambda r: None)
    _steps(ref, np.random.default_rng(0), 1, lambda r: None)
    before, gen, it = _port_state(tr), tr.gen.get_state(), tr.it
    tr.release_step_programs()
    audio, fs = _batch(rng)
    prog = tr.compile_step(audio, fs)
    assert prog is not None and tr.step_programs_built == 2
    assert tr.it == it and torch.equal(tr.gen.get_state(), gen)
    _assert_same_state(tr, ref)
    assert all(torch.equal(before[k][n], _port_state(tr)[k][n]) for k in before for n in tr.names)
    m = tr.train_step(audio, fs)
    assert tr.step_programs_built == 2 and list(tr._step_programs.values()) == [prog]
    assert _metrics_equal(m, ref.train_step(audio, fs))
    _assert_same_state(tr, ref)
    restore = tr._snapshot()     # undoes the build's warm-up step on the card
    tr._step(*tr._inputs(*tr._split(*_batch(rng))), torch.tensor(0.5))
    restore()
    _assert_same_state(tr, ref)
    fresh = _port(tmp, TINY, sub="fresh")
    fresh.ema = None
    with pytest.raises(RuntimeError, match="init_state"):
        fresh.compile_step(audio, fs)


def test_the_step_program_is_freed_with_its_trainer(tmp_path):
    """The step program holds its trainer weakly and the trainer holds no
    cycle: dropping a trainer that trained frees its program (and, on the
    card, its graph pool) by reference counting alone."""
    import gc
    import weakref
    gc.collect()
    gc.disable()
    try:
        tr = _port(str(tmp_path), TINY)
        _steps(tr, np.random.default_rng(0), 1, lambda r: None)
        (prog,) = tr._step_programs.values()
        refs = [weakref.ref(tr), weakref.ref(prog)]
        del tr, prog
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


@pytest.mark.parametrize("change", ["load_in_place", "resume", "init_state"])
def test_a_reload_rebuilds_the_step_program(tmp_path, change):
    """A new or reloaded state drops the program built over the old one;
    the next step builds another."""
    tmp = str(tmp_path)
    tr = _port(tmp, TINY)
    rng = np.random.default_rng(0)
    _steps(tr, rng, 2, _numpy_draws)
    old = next(iter(tr._step_programs.values()))
    _steps(tr, rng, 1, _numpy_draws)
    assert tr.step_programs_built == 1
    if change == "load_in_place":
        tr.load_state_dict(tr.state_dict())
    elif change == "resume":
        assert tr.resume_from_checkpoint(tr.save_checkpoint())
    else:
        tr.init_state()
    _steps(tr, rng, 1, _numpy_draws)
    (new,) = tr._step_programs.values()
    assert tr.step_programs_built == 2 and new is not old


def test_checkpoint_roundtrip_and_resume_continues_like_uninterrupted(tmp_path):
    """The port's own format: 2 steps, save, a fresh trainer finds the
    checkpoint by the latest-checkpoint scan and holds the same state; one
    more step from there equals the third step of the uninterrupted run."""
    tmp = str(tmp_path)
    whole = _port(tmp, TINY, sub="whole")
    _steps(whole, np.random.default_rng(0), 3, _numpy_draws)
    first = _port(tmp, TINY, sub="run")
    rng = np.random.default_rng(0)
    _steps(first, rng, 2, _numpy_draws)
    path = first.save_checkpoint()
    assert path.endswith("22k_8s-2.pt") and not os.path.exists(path + ".tmp")
    saved = ckpt.load(path)
    assert set(saved) == {"it", "network", "ema", "optimizer", "gnorm_ema", "applied"}
    second = _port(tmp, TINY, sub="run")
    assert second.resume_from_checkpoint()
    _assert_same_state(second, first)
    _steps(second, rng, 1, _numpy_draws)
    _assert_same_state(second, whole)


def test_shape_matched_partial_resume(tmp_path):
    """A checkpoint of another width: every tensor whose name and shape
    agree is copied, the others keep their fresh values, the optimizer
    restarts and the iteration carries over."""
    tmp = str(tmp_path)
    src = _port(tmp, TINY + ["network.Ns=[8,16,24]"], sub="src")
    _steps(src, np.random.default_rng(0), 2, _numpy_draws)
    payload = src.state_dict()
    dst = _port(tmp, TINY, sub="dst")
    fresh = _port_state(dst)["params"]
    dst.load_state_dict(payload)
    same = [n for n in dst.names
            if tuple(payload["network"][n].shape) == tuple(fresh[n].shape)]
    assert 0 < len(same) < len(dst.names)
    got = _port_state(dst)
    for n in dst.names:
        want = payload["network"][n] if n in same else fresh[n]
        torch.testing.assert_close(got["params"][n], want, rtol=0, atol=0)
        assert not got["mu"][n].any() and not got["nu"][n].any()
    assert (dst.it, int(dst.count)) == (2, 0)


def test_jax_stream_checkpoint_resumes_in_the_port(tmp_path):
    """A checkpoint written by the JAX Trainer.save_checkpoint (stream
    format) resumes in the port, found by the latest-checkpoint scan, to the
    same parameters, EMA, Adam moments and count, guardrail state and
    iteration; the conversion is a relayout, so the match is exact."""
    tmp = str(tmp_path)
    jtr = _jax(tmp, TINY)
    rng = np.random.default_rng(0)
    for _ in range(2):
        jtr.train_step(*_batch(rng))
    path = jtr.save_checkpoint()
    assert os.path.isdir(path) and path.endswith(".ckpt")
    ta = compose(overrides=TINY + [f"model_dir={tmp}/jax"])
    net = tsetup.setup_network(ta, device="cpu", seed=5, trainable=True)
    tr = tsetup.setup_trainer(ta, network=net, diff_params=tsetup.setup_diff_parameters(ta))
    assert ckpt.list_checkpoints(tr.model_dir, "22k_8s") == [path]
    assert tr.resume_from_checkpoint()
    ref, got = _jax_state(jtr), _port_state(tr)
    for k in ref:
        for n in tr.names:
            np.testing.assert_array_equal(got[k][n].numpy(), ref[k][n].numpy(), err_msg=k + n)
    s = jax.device_get(jtr.state)
    assert (tr.it, int(tr.count), int(tr.applied), float(tr.gnorm_ema)) == (
        int(s.it), int(s.opt_state[1].count), int(s.applied), float(s.gnorm_ema))


def test_checkpoint_listing_and_remove_last(tmp_path):
    """The latest-checkpoint scan orders by iteration (the port's file after
    a JAX stream directory of the same iteration, a directory without a
    manifest ignored); remove_last_checkpoint deletes only the port's older
    files; with nothing to resume the trainer starts fresh."""
    tr = _port(str(tmp_path), TINY + ["logging.remove_last_checkpoint=True"])
    assert not tr.resume_from_checkpoint()
    md = tmp_path / "torch"
    for name in ("22k_8s-3.ckpt", "22k_8s-10.ckpt"):
        (md / name).mkdir()
        (md / name / "stream_manifest.json").write_text("{}")
    (md / "22k_8s-7.ckpt").mkdir()                      # no manifest: not a checkpoint
    tr.it = 3
    tr.save_checkpoint()
    tr.it = 10
    last = tr.save_checkpoint()
    assert [os.path.basename(p) for p in ckpt.list_checkpoints(str(md), "22k_8s")] == [
        "22k_8s-3.ckpt", "22k_8s-10.ckpt", "22k_8s-10.pt"]
    assert ckpt.list_checkpoints(str(md), "22k_8s")[-1] == last


@pytest.mark.parametrize("override,exc", [
    ("network.quant=int8", ValueError),
])
def test_trainer_refuses_unported_modes(override, exc):
    ta = compose(overrides=TINY + [override, "model_dir=unused"])
    net = tsetup.setup_network(compose(overrides=TINY), device="cpu", trainable=True)
    with pytest.raises(exc):
        tsetup.setup_trainer(ta, network=net, diff_params=tsetup.setup_diff_parameters(ta))


@pytest.mark.parametrize("override", ["exp.mesh.fsdp=True", "exp.mesh.distributed=True",
                                      "exp.mesh.dp=2"])
def test_mesh_options_without_a_process_group_train_on_one_device(tmp_path, override):
    """The trainer splits the batch only over a process group (which the
    entry point starts, tests/test_torch_parallel.py runs one); without one,
    exp.mesh changes nothing: the same step as without the option."""
    tmp = str(tmp_path)
    plain, meshed = _port(tmp, TINY, sub="plain"), _port(tmp, TINY + [override], sub="mesh")
    assert meshed.mesh is None and meshed.model is meshed.net and meshed.n_dp == 1
    for tr in (plain, meshed):
        _steps(tr, np.random.default_rng(0), 2, _numpy_draws)
    _assert_same_state(meshed, plain)


def test_logging_sinks(tmp_path):
    """The loss-by-sigma plot redraws one figure into a PNG (or skips with
    one line without matplotlib); wandb stays off unless asked for (a run
    is never started here: it would need the network)."""
    from aid_tpu_torch.utils import logging_utils as logu
    plot = logu.LossBySigmaPlot()
    edges = np.exp(np.linspace(np.log(1e-5), np.log(10.0), 5))
    for _ in range(2):
        out = plot(edges, np.ones(4), 0.1 * np.ones(4), str(tmp_path / "lbs.png"))
    assert out is None or os.path.getsize(out) > 0
    for cfg in (None, {"use": False, "project": "p"}):
        w = logu.WandbLogger(cfg, args_dict={})
        w.log({"loss": 1.0})
        w.finish()
        assert w._run is None


def test_failing_demo_is_skipped_then_turned_off(tmp_path, capsys):
    """A demo that raises is skipped with its traceback and training goes
    on; after two failures in a row the trainer stops asking for demos."""
    tr = _port(str(tmp_path), TINY)
    calls = []

    class Failing:
        def sample_unconditional_ema(self, ema):
            calls.append(set(ema) == set(tr.names))
            raise RuntimeError("demo broke")

    tr.tester = Failing()
    for _ in range(3):
        tr.heavy_logging()
    assert calls == [True, True]
    out = capsys.readouterr()
    assert "demos off" in out.out and "demo broke" in out.err


@pytest.fixture(scope="module")
def wav_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    rows = ["split,year,audio_filename"]
    rng = np.random.default_rng(3)
    for j, fs in enumerate((44100, 48000, 44100)):
        audio_io.write(str(root / f"f{j}.wav"), rng.standard_normal(6000) * 0.1, fs)
        rows.append(f"train,2015,f{j}.wav")
    (root / "maestro-v3.0.0.csv").write_text("\n".join(rows) + "\n")
    return str(root)


def test_train_entry_runs_on_generated_wavs(wav_corpus, tmp_path, capsys):
    """python -m aid_tpu_torch.train on the CPU: 2 steps on mixed-rate WAVs
    with the entry's defaults (remat on, f32), a checkpoint at step 2 and a
    profiler trace of step 2."""
    md = str(tmp_path / "run")
    ov = [o for o in TINY if not o.startswith(("network.remat", "network.compute_dtype",
                                                 "exp.total_its"))]
    assert ttrain.main(ov + [f"dset.path={wav_corpus}", "dset.load_len=4500",
                             "dset.years=[2015]", "exp.total_its=2",
                             "logging.save_interval=2", f"model_dir={md}",
                             "logging.profiling.enabled=True", "logging.profiling.start_it=1",
                             "logging.profiling.num_its=1"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "it 1  loss" in out and "it 2  loss" in out and "done at iteration 2" in out
    saved = ckpt.load(os.path.join(md, "22k_8s-2.pt"))
    assert saved["it"] == 2 and saved["optimizer"]["count"] == 2
    assert all(torch.isfinite(v).all() for v in saved["network"].values())
    assert os.path.exists(os.path.join(md, "profile", "trace_it2.json"))


def test_train_entry_writes_the_demo(wav_corpus, tmp_path):
    """heavy_log_interval=2: after step 2 the entry's tester samples with
    the EMA weights into model_dir/heavy_logging/it_2/."""
    md = tmp_path / "run"
    ov = [o for o in TINY if not o.startswith("exp.total_its")]
    assert ttrain.main(ov + [f"dset.path={wav_corpus}", "dset.load_len=4500",
                             "dset.years=[2015]", "exp.total_its=2",
                             "logging.heavy_log_interval=2", "tester.T=2",
                             "tester.unconditional.num_samples=1",
                             "tester.unconditional.audio_len=2048", f"model_dir={md}"],
                       device="cpu") == 0
    demo = md / "heavy_logging" / "it_2"
    x, fs = audio_io.read(str(demo / "uncond_0.wav"))
    assert x.shape == (2048,) and fs == 22050 and np.isfinite(x).all() and np.abs(x).max() > 0
    assert sorted(os.listdir(demo)) in (["uncond_0.wav"], ["uncond_0.wav", "uncond_0.wav.png"])
    assert not (md / "heavy_logging" / "it_1").exists()


def test_train_entry_defaults_and_dry_run(capsys):
    assert ttrain.main(["dry_run=True"], device="cpu") == 0
    out = capsys.readouterr().out
    assert '"remat": true' in out and '"compute_dtype": "float32"' in out
    assert ttrain.main(["dry_run=True", "network.remat=False",
                        "network.compute_dtype=bfloat16"], device="cpu") == 0
    out = capsys.readouterr().out
    assert '"remat": false' in out and '"compute_dtype": "bfloat16"' in out
