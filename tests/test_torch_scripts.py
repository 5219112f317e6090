"""The port's user scripts at a tiny configuration on the CPU (T=2):
``make_synth_corpus_torch`` against the JAX package's corpus (the same
samples), ``parity_vs_reference_torch`` against the JAX steps of
``scripts/parity_vs_reference.py`` on the same ``.pt``, the demo in both
modes, ``serve_bench_torch``, both evaluation scripts over two port
checkpoints and a JAX stream checkpoint, and ``e2e_smoke_torch.run`` at 2
iterations with its gate as a pure function."""
import argparse
import importlib.util
import json
import math
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aid_tpu import setup as asetup
from aid_tpu.diffusion import edm as jedm
from aid_tpu.utils import checkpoint_torch as jct
from aid_tpu.utils import ckpt_io as jckpt_io
from aid_tpu.utils.config import compose as jcompose
from aid_tpu_torch import setup as tsetup
from aid_tpu_torch.data import audio_io
from aid_tpu_torch.models.unet_cqt import MAIN_SCALE
from aid_tpu_torch.utils import checkpoint_torch as tct
from aid_tpu_torch.utils.config import compose
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import demo_inpainting_torch as demo  # noqa: E402
import e2e_smoke_torch as e2e  # noqa: E402
import eval_checkpoints_torch as evalck  # noqa: E402
import eval_gap_sweep_torch as sweep  # noqa: E402
import make_synth_corpus_torch as corpus_torch  # noqa: E402
import parity_vs_reference_torch as parity  # noqa: E402
import serve_bench_torch as serve_bench  # noqa: E402

NET = ["network.cqt.num_octs=3", "network.cqt.bins_per_oct=8", "network.Ns=[8,16,16]",
       "network.num_dils=[1,2,2]", "network.attention_layers=[0,0,1,1]"]
TINY = ["exp.audio_len=2048", *NET, "tester.T=2"]
# the evaluation scripts' 1.5 s gap (and the sweep's 371-1486 ms ones) need
# a window of seconds: 8192 samples at 4 kHz (2.05 s)
EVAL = ["exp.audio_len=8192", "exp.sample_rate=4000", *NET, "tester.T=4"]
PARITY_TOL = 1e-5        # max|d| / max|ref| of the denoised tensors, f32 both sides


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts",
                                                                     name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _finite(*xs):
    return all(math.isfinite(float(v)) for v in xs)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two 13 s test files of the synthetic corpus's music in the 2009
    split, at 8 kHz: twice the tiny evaluation config's 4 kHz, as 44.1 kHz
    files are to the flagship's 22.05 kHz (the scripts read 2L + 256
    samples at the file's rate and keep L after resampling)."""
    root = tmp_path_factory.mktemp("corpus")
    (root / "2009").mkdir()
    rng = np.random.default_rng(0)
    for j in range(2):
        x = audio_io.resample_host(corpus_torch.make_file(rng, 13.0), corpus_torch.FS, 8000)
        audio_io.write(str(root / "2009" / f"test_{j:03d}.wav"), x, 8000)
    return str(root)


@pytest.fixture(scope="module")
def tiny_pt(tmp_path_factory):
    """A reference-layout .pt of the tiny net with trained-like gates."""
    d = tmp_path_factory.mktemp("pt")
    net = tsetup.setup_network(compose(overrides=TINY), device="cpu", seed=0)
    net.init_weights(0, gate_scale=MAIN_SCALE)
    return tct.export_checkpoint(str(d / "tiny-1.pt"), net, it=1)


def test_synth_corpus_has_the_jax_scripts_samples(tmp_path, monkeypatch):
    jax_script = _load_script("make_synth_corpus")
    monkeypatch.setattr(sys, "argv", ["make_synth_corpus.py", str(tmp_path / "jax"), "2", "1",
                                      "1.5"])
    jax_script.main()
    rows = corpus_torch.write_corpus(str(tmp_path / "port"), 2, 1, 1.5)
    assert [r["audio_filename"] for r in rows] == ["2015/train_000.wav", "2017/train_001.wav",
                                                   "2009/test_000.wav"]
    assert ((tmp_path / "jax" / "maestro-v3.0.0.csv").read_text()
            == (tmp_path / "port" / "maestro-v3.0.0.csv").read_text())
    for r in rows:
        a, fa = audio_io.read(str(tmp_path / "jax" / r["audio_filename"]))
        b, fb = audio_io.read(str(tmp_path / "port" / r["audio_filename"]))
        assert fa == fb == 44100 and a.shape == (66150,)
        np.testing.assert_array_equal(a, b)


def test_parity_export_matches_the_jax_steps(tiny_pt, tmp_path):
    npz = str(tmp_path / "port.npz")
    cli = parity.parse(["--pt", tiny_pt, "--export", npz, "--device", "cpu"])
    got = parity.run(cli, overrides=TINY)
    # the JAX script's steps (scripts/parity_vs_reference.py:57-77) on the same .pt
    ja = jcompose(overrides=["network=cqtdiff_plus_22k", "exp=maestro22k_8s",
                             "network.compute_dtype=float32", f"model_dir={tmp_path}", *TINY])
    L = int(ja.exp.audio_len)
    bundle = asetup.setup_network(ja)
    bundle.init(jax.random.PRNGKey(0), 1, L)
    bundle.params = jct.load_reference_checkpoint(tiny_pt, bundle)
    p = asetup.setup_diff_parameters(ja).params
    rng = np.random.default_rng(1234)
    x = jnp.asarray(rng.standard_normal((1, L)) * 0.063, jnp.float32)
    sigmas = np.asarray([1e-3, 1e-2, 1e-1, 0.5, 1.0], np.float32)
    fwd = jax.jit(lambda xn, s: jedm.denoiser(
        p, lambda q, cn: bundle.module.apply(bundle.params, q, cn), xn, s))
    outs = []
    for s in sigmas:
        xn = x + s * jnp.asarray(rng.standard_normal((1, L)), jnp.float32)
        outs.append(np.asarray(fwd(xn, jnp.full((1, 1), s))))
    ref = np.stack(outs)
    saved = np.load(npz)
    assert sorted(saved.files) == ["denoised", "sigmas", "x"]
    np.testing.assert_array_equal(saved["x"], np.asarray(x))
    np.testing.assert_array_equal(saved["sigmas"], sigmas)
    assert saved["denoised"].shape == ref.shape == (5, 1, L)
    assert np.abs(got["denoised"] - ref).max() / np.abs(ref).max() < PARITY_TOL
    # --compare passes against its own export and fails against a moved one
    cli = parity.parse(["--pt", tiny_pt, "--compare", npz, "--device", "cpu"])
    assert parity.run(cli, overrides=TINY)["max_abs_diff"] == 0.0
    np.savez(tmp_path / "moved.npz", denoised=ref + 2e-3)
    with pytest.raises(SystemExit, match="parity FAILED"):
        parity.run(parity.parse(["--pt", tiny_pt, "--compare", str(tmp_path / "moved.npz"),
                                 "--device", "cpu"]), overrides=TINY)


@pytest.fixture(scope="module")
def init_pt(tmp_path_factory):
    """A reference-layout .pt of the tiny net at its reference init (gates
    at 1e-7): its fill stays below full scale, so no written wav is
    normalised."""
    d = tmp_path_factory.mktemp("pt_init")
    net = tsetup.setup_network(compose(overrides=TINY), device="cpu", seed=0)
    return tct.export_checkpoint(str(d / "tiny-0.pt"), net, it=0)


@pytest.mark.parametrize("spectrogram", [False, True])
def test_demo(init_pt, tmp_path, spectrogram):
    # T=8: at T=2 the fill of this untrained net reaches hundreds, and the
    # written wav is normalised (the reference's write semantics)
    argv = ["--T", "8", "--out", str(tmp_path), "--device", "cpu", "--checkpoint", init_pt,
            "--gap-ms", "20"] + (["--spectrogram"] if spectrogram else [])
    out = demo.run(demo.parse(argv), overrides=["exp.audio_len=2048", *NET,
                                                "tester.spectrogram_inpainting.time_mask_length=30"])
    for name in ("original", "degraded", "reconstructed"):
        x, fs = audio_io.read(out["paths"][name])
        assert fs == 22050 and x.shape == (2048,) and np.isfinite(x).all()
    x, rec = out["signals"]["original"], out["signals"]["reconstructed"]
    assert np.isfinite(rec).all() and not np.array_equal(rec, x)
    if not spectrogram:
        # observed samples farther than the data consistency's Hann ramp
        # from the gap: the written file's are the input's, bit for bit
        gap = int(0.02 * 22050)
        s = (2048 - gap) // 2
        far = np.ones(2048, bool)
        far[s - 50:s + gap + 50] = False
        orig = audio_io.read(out["paths"]["original"])[0]
        np.testing.assert_array_equal(audio_io.read(out["paths"]["reconstructed"])[0][far],
                                      orig[far])
        assert np.abs(rec[far] - x[far]).max() < 1e-6


def test_demo_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        demo.run(demo.parse([]), overrides=TINY)


def test_serve_bench_rows(capsys):
    rows = serve_bench.run(overrides=[*EVAL[:-1], "tester.T=2"], reps=1, device="cpu")
    assert [r["case"] for r in rows] == ["single_gap_latency_b1", "two_gap_cobatch_b2",
                                         "chained_long_gap_b2"]
    for r in rows:
        assert _finite(r["latency_s"], r["rtf"]) and r["latency_s"] > 0
        assert r["card"] == "cpu (no card)"
    out = capsys.readouterr().out
    assert out.count('"case"') == 3 and "| case | latency s |" in out


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory, tiny_pt):
    """Two port checkpoints (it 1 and 2) and a JAX stream checkpoint (it 3)
    of the tiny net, named as training runs name them."""
    d = tmp_path_factory.mktemp("run")
    args = compose(overrides=["exp=maestro22k_8s", *TINY, f"model_dir={d}",
                              "logging.remove_last_checkpoint=False"])
    net = tsetup.setup_network(args, device="cpu", seed=0, trainable=True)
    tr = tsetup.setup_trainer(args, network=net, diff_params=tsetup.setup_diff_parameters(args))
    tr.init_state()
    for it in (1, 2):
        tr.it = it
        with torch.no_grad():
            for e in tr.ema:
                e.mul_(0.9)
        tr.save_checkpoint()
    ja = jcompose(overrides=["exp=maestro22k_8s", *TINY, f"model_dir={d}"])
    bundle = asetup.setup_network(ja)
    bundle.init(jax.random.PRNGKey(0), 1, 2048)
    tree = jct.load_reference_checkpoint(tiny_pt, bundle)
    jckpt_io.save_stream(str(d / "22k_8s-3.ckpt"), {"it": 3, "network": tree, "ema": tree})
    return str(d)


def test_eval_checkpoints(run_dir, corpus, tmp_path):
    env = {"EVAL_BATCH": "2", "EVAL_WAV_DIR": str(tmp_path / "wavs")}
    ledger = evalck.run(run_dir, corpus, 2, EVAL, device="cpu", env=env)
    with open(os.path.join(run_dir, "eval_ledger.json")) as f:
        assert json.load(f) == json.loads(json.dumps(ledger))
    assert set(ledger) == {"workload", "n_clips", "masked_baseline", "columns", "rows"}
    assert ledger["n_clips"] == 2 and "T=4" in ledger["workload"]
    assert [r[0] for r in ledger["rows"]] == [1, 2, 3]
    assert all(_finite(*r) for r in ledger["rows"])
    base = ledger["masked_baseline"]
    # the zeroed gap: 0 dB by the SNR's definition, a real spectral distance
    assert _finite(*base.values()) and abs(base["gap_snr_db"]) < 1e-6 and base["gap_lsd"] > 1
    assert sorted(os.listdir(tmp_path / "wavs"))[:2] == ["clip0_masked.wav", "clip0_orig.wav"]
    only = evalck.run(run_dir, corpus, 2, EVAL, device="cpu", env={"EVAL_ITS": "2"})
    assert [r[0] for r in only["rows"]] == [2]
    # the same checkpoint gives the same row in both runs (EVAL_SEED fixed)
    assert only["rows"][0] == ledger["rows"][1]


def test_eval_gap_sweep(run_dir, corpus):
    """A window of 8192 samples at 4 kHz takes the 371, 743 and 1486 ms
    gaps and skips 2962 ms (it would leave under 2048 samples of context)."""
    table = sweep.run(os.path.join(run_dir, "22k_8s-2.pt"), corpus, 2, EVAL, device="cpu")
    assert [r[0] for r in table["rows"]] == [371, 743, 1486]
    assert all(_finite(*r) for r in table["rows"]) and table["n_clips"] == 2
    assert os.path.exists(os.path.join(run_dir, "gap_sweep.json"))


EVAL_TOL = 1e-5          # clips: max|d|; SNR (dB) and LSD: |d| / max(1, |ref|)


@pytest.mark.parametrize("script", ["eval_checkpoints", "eval_gap_sweep"])
def test_eval_scripts_hold_to_the_jax_scripts(script, run_dir, corpus, tmp_path, monkeypatch):
    """The deterministic part of each evaluation script against the JAX
    script on the same corpus and JAX stream checkpoint: the held-out clips
    (offsets, 2L + 256 samples resampled, cropped to L), the gap placement
    and the gap SNR and LSD, the masked floor included. Both samplers are
    replaced by one that returns its masked input, since the two packages'
    noise cannot be matched; so the rows score the masked input on both
    sides. FAD is left out: the JAX log-mel embedder runs its mel filterbank
    over time (a reference-side fault recorded with the metrics)."""
    import aid_tpu.training.utils as jtu
    from aid_tpu.sampling.sampler import Sampler as JSampler
    from aid_tpu_torch.sampling.sampler import Sampler as TSampler

    md = tmp_path / "run"
    md.mkdir()
    shutil.copytree(os.path.join(run_dir, "22k_8s-3.ckpt"), md / "22k_8s-3.ckpt")
    monkeypatch.setattr(JSampler, "predict_inpainting", lambda self, y, mask, key: y)
    monkeypatch.setattr(TSampler, "predict_inpainting",
                        lambda self, y, mask, generator=None, **k: y)
    # the JAX scripts point jax at a compile cache under HOME; keep the
    # process's jax settings as they are
    update = jax.config.update
    monkeypatch.setattr(jax.config, "update", lambda name, value: None
                        if name.startswith("jax_persistent_cache") or name.startswith(
                            "jax_compilation_cache") else update(name, value))
    L = 8192
    jclips, tclips = [], []
    resample = jtu.resample_batch
    monkeypatch.setattr(jtu, "resample_batch",
                        lambda *a, **k: jclips.append(np.asarray(resample(*a, **k))[:, :L])
                        or jnp.asarray(jclips[-1]))
    port = evalck if script == "eval_checkpoints" else sweep
    load_clip = port.load_clip
    monkeypatch.setattr(port, "load_clip", lambda *a: tclips.append(load_clip(*a))
                        or tclips[-1])
    monkeypatch.setenv("EVAL_BATCH", "2")
    target = str(md) if script == "eval_checkpoints" else str(md / "22k_8s-3.ckpt")
    monkeypatch.setattr(sys, "argv", [script + ".py", target, corpus, "2", *EVAL])
    _load_script(script).main()
    ledger_name = "eval_ledger.json" if script == "eval_checkpoints" else "gap_sweep.json"
    with open(md / ledger_name) as f:
        want = json.load(f)
    got = port.run(target, corpus, 2, EVAL, device="cpu", env={"EVAL_BATCH": "2"})

    assert len(jclips) == len(tclips) == 2
    for a, b in zip(jclips, tclips):
        assert a.shape == b.shape == (1, L)
        assert np.abs(a - b).max() < EVAL_TOL

    def close(a, b):
        return abs(a - b) / max(1.0, abs(a)) < EVAL_TOL

    assert got["n_clips"] == want["n_clips"] == 2 and got["columns"] == want["columns"]
    if script == "eval_checkpoints":
        for k in ("gap_snr_db", "gap_lsd"):
            assert close(want["masked_baseline"][k], got["masked_baseline"][k]), k
    assert [r[0] for r in got["rows"]] == [r[0] for r in want["rows"]]
    assert len(want["rows"]) == (1 if script == "eval_checkpoints" else 3)
    for w, g in zip(want["rows"], got["rows"]):
        assert close(w[1], g[1]) and close(w[2], g[2]), (w, g)


def test_e2e_smoke_run_on_the_cpu(tmp_path, capsys):
    cfg = e2e.config_from_env({"SMOKE_L": "2048", "SMOKE_ITS": "2", "SMOKE_DTYPE": "float32"})
    cfg["model_dir"] = str(tmp_path)
    res = e2e.run(cfg, device="cpu")
    # the JAX package's scripts/train_report.py reads the port trainer's log lines
    log = tmp_path / "train.log"
    log.write_text(capsys.readouterr().out)
    rows, _ = _load_script("train_report").parse(str(log))
    assert [r[0] for r in rows] == [1] and _finite(rows[0][1], rows[0][3])
    assert res["its"] == 2 and res["device"] == "cpu"
    assert _finite(res["snr_untrained_db"], res["snr_trained_db"], res["lsd_gap_ratio"],
                   res["s_per_it"])
    assert res["ok"] == e2e.gate(res["snr_gain_db"], res["lsd_gap_ratio"], 4.0, 0.95)
    assert os.path.exists(res["checkpoint"]) and res["rec"].shape == (1, 2048)
    assert (tmp_path / "reconstructed.wav").exists()


@pytest.mark.parametrize("gain,ratio,ok", [(4.0, 0.95, True), (5.97, 0.869, True),
                                           (3.99, 0.5, False), (6.0, 0.951, False)])
def test_e2e_gate(gain, ratio, ok):
    assert e2e.gate(gain, ratio, 4.0, 0.95) is ok


def test_e2e_config_from_env():
    cfg = e2e.config_from_env({})
    assert (cfg["L"], cfg["its"], cfg["dtype"], cfg["min_gain_db"], cfg["max_lsd_ratio"]) == (
        16384, 400, "bfloat16", 4.0, 0.95)
    assert not (cfg["gelu_sweep"] or cfg["quant_sweep"]) and cfg["gelu"] is None
    ov = e2e.overrides(e2e.config_from_env({"SMOKE_GELU": "erf"}), "float32")
    assert "network.gelu=erf" in ov and "network.compute_dtype=float32" in ov


def test_scripts_parse_their_arguments():
    assert evalck.split_argv(["md", "c", "3", "a.b=1", "--device", "cpu"]) == (
        ["md", "c", "3"], ["a.b=1"], "cpu")
    cli = demo.parse([])
    assert (cli.gap_ms, cli.xi, cli.T, cli.device, cli.spectrogram) == (1500.0, 0.35, 35,
                                                                        None, False)
    assert isinstance(parity.parse(["--pt", "x.pt"]), argparse.Namespace)


def test_seed_sweep_reads_both_scripts_lines():
    """scripts/e2e_seed_sweep.py reads the lines that both learning-gate
    scripts print (the same format strings) and summarises each package."""
    seed_sweep = _load_script("e2e_seed_sweep")
    text = ("gap SNR untrained: -11.12 dB\ntrained 150 its in 96.5s\n"
            "gap SNR after training: -5.51 dB (untrained -11.12)\n"
            "gates: snr gain 5.61 dB (min 4.0), gap-LSD ratio 0.862 (max 0.95)\nE2E SMOKE PASS\n")
    row = seed_sweep.parse(text)
    assert row == {"snr_untrained_db": -11.12, "snr_trained_db": -5.51, "snr_gain_db": 5.61,
                   "lsd_gap_ratio": 0.862, "train_s": 96.5, "pass": True}
    assert seed_sweep.parse("E2E SMOKE FAIL")["snr_gain_db"] is None
    rows = [{"package": "torch", **row}, {"package": "torch", **row, "snr_gain_db": 3.61,
                                           "pass": False}]
    got = seed_sweep.summary(rows)["torch"]
    assert (got["n"], got["passed"], got["gain_db"]["min"], got["gain_db"]["max"]) == (
        2, 1, 3.61, 5.61)
    assert abs(got["gain_db"]["mean"] - 4.61) < 1e-12


def test_learning_gate_net_init_has_the_jax_init_law():
    """The learning gate's tiny net starts from the JAX package's
    initialisation law: the same tensors and shapes, the same constants
    (zeros, ones, the fixed Fourier tables), and per random tensor of at
    least 256 elements a standard deviation within 0.8-1.25 of JAX's (the
    two packages draw from their own streams, so only the law can agree;
    a sample std of n >= 256 values is within ~5% of its law's)."""
    from aid_tpu_torch.utils.convert import state_dict_from_flax
    ov = e2e.overrides(e2e.config_from_env({"SMOKE_L": "2048", "SMOKE_DTYPE": "float32"}),
                       "float32")
    bundle = asetup.setup_network(jcompose(overrides=ov))
    bundle.init(jax.random.PRNGKey(0), 1, 2048)
    want = state_dict_from_flax(jax.device_get(bundle.params))
    net = tsetup.setup_network(compose(overrides=ov), device="cpu", seed=0, trainable=True)
    got = {k: v.detach().float() for k, v in net.state_dict().items()}
    assert sorted(got) == sorted(want)
    checked = 0
    for k, w in want.items():
        w, g = w.float(), got[k]
        assert g.shape == w.shape, k
        if w.numel() == 1 or float(w.std()) == 0.0:
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=k)
        elif w.numel() >= 256:
            assert 0.8 < float(g.std()) / float(w.std()) < 1.25, k
            checked += 1
    assert checked > 100
