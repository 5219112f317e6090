"""The port's bench (``bench_torch.py``) against the JAX package's
(``bench.py``).

Each leg composes the JAX bench's config tree in both packages, at the
full size and under ``tests/test_bench.py``'s tiny overrides; the masks
are ``bench.py``'s arithmetic; the headline leg built by the port's
``build`` runs the JAX sampler's trajectory on the same weights and noise.
Then the script runs on the CPU (``BENCH_DEVICE=cpu``) as
``tests/test_bench.py`` runs the JAX bench, with two ranks under
``torch.distributed.run`` (dp and tp), and without CUDA and no device
asked for, where it must fail with the port's own error. The script runs
start together (one process each, a thread each) and each test reads
its own.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from aid_tpu import setup as asetup
from aid_tpu.utils.config import compose as jax_compose
from aid_tpu_torch.utils.config import compose
from aid_tpu_torch.utils.convert import state_dict_from_flax
from tests.test_bench import TINY
from tests.test_torch_config import _flatten, _plain
from tests.test_torch_launchers import _free_port
from tests.test_torch_sampler import TRAJ_TOL, _jax_noise
from tests.test_torch_unet import rel_err, trained_like
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import bench_torch  # noqa: E402

TINY_WORDS = TINY.split()
# keys only the port's exp files carry, at the JAX trainer's defaults
# (tests/test_torch_config.py, PORT_ONLY): test_cqtdiff_22k (every tiny
# leg) and musicnet44k_4s (the 44k leg) have none of them on the JAX side
TRAINER_KEYS = {"exp.skip_grad_norm": 0, "exp.skip_grad_factor": 0,
                "exp.stall_timeout_s": 1800, "exp.max_host_rss_gb": 0}
PORT_ONLY = {("headline", "full"): {}, ("shortgaps", "full"): {}, ("uncond", "full"): {},
             ("44k", "full"): TRAINER_KEYS, **{(leg, "tiny"): TRAINER_KEYS
                                                for leg in bench_torch.LEGS}}
CUDA_ERROR = "aid_tpu_torch runs on a CUDA device"
# the bench's knobs: each run sets those it means, none leaks in
KNOBS = ("BENCH_BATCH", "BENCH_REPS", "BENCH_SUITE", "BENCH_BUDGET_S", "BENCH_OVERRIDES",
         "BENCH_DEVICES", "BENCH_TP", "BENCH_DEVICE")
ENV = {k: v for k, v in os.environ.items() if k not in KNOBS}


def _start(tmp, name, ranks=0, **knobs):
    """``bench_torch.py`` with ``knobs`` (under ``torch.distributed.run``
    with ``ranks`` ranks when above 0), one thread each, its output in
    ``tmp/<name>.log``."""
    env = dict(ENV, OMP_NUM_THREADS="1", BENCH_BATCH="1", BENCH_REPS="1",
               BENCH_OVERRIDES=TINY + f"model_dir={tmp / name}", **knobs)
    script = str(ROOT / "bench_torch.py")
    cmd = ([sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(ranks),
            "--master-port", str(_free_port()), script] if ranks else [sys.executable, script])
    with open(tmp / f"{name}.log", "w") as out, open(tmp / f"{name}.err", "w") as err:
        return subprocess.Popen(cmd, env=env, stdout=out, stderr=err, cwd=str(tmp)), tmp, name


RUNS = {
    "headline": dict(BENCH_DEVICE="cpu", BENCH_SUITE="headline"),
    "full": dict(BENCH_DEVICE="cpu", BENCH_SUITE="full"),
    "dp2": dict(BENCH_DEVICE="cpu", BENCH_SUITE="headline", BENCH_DEVICES="2", ranks=2),
    "tp2": dict(BENCH_DEVICE="cpu", BENCH_SUITE="headline", BENCH_TP="2", ranks=2),
}


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    """The script runs, started with the module's first test."""
    tmp = tmp_path_factory.mktemp("bench")
    procs = {name: _start(tmp, name, **knobs) for name, knobs in RUNS.items()}
    if not torch.cuda.is_available():
        procs["no_cuda"] = _start(tmp, "no_cuda", BENCH_SUITE="headline")
    yield procs
    for p, _, _ in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.mark.parametrize("size", ["full", "tiny"])
@pytest.mark.parametrize("leg", list(bench_torch.LEGS))
def test_leg_composes_the_jax_benchs_tree(leg, size):
    words = bench_torch.LEGS[leg] + (TINY_WORDS if size == "tiny" else [])
    ref = _flatten(_plain(jax_compose(overrides=words)))
    port = _flatten(_plain(compose(overrides=words)))
    only = {k: port.pop(k) for k in set(port) - set(ref)}
    assert only == PORT_ONLY[(leg, size)]
    assert set(port) == set(ref)
    for key, value in ref.items():
        if key.endswith("callable"):
            assert value.startswith("aid_tpu.") and port[key] == "aid_tpu_torch." + value[8:]
        else:
            assert port[key] == value, key


def _jax_center_gap(batch, L, fs, gap_ms=1500.0):
    """bench.py:149-154."""
    gap = int(gap_ms / 1000 * fs)
    m = np.ones((batch, L), np.float32)
    s = (L - gap) // 2
    m[:, s:s + gap] = 0.0
    return m


def _jax_shortgaps(batch, L1, fs1):
    """bench.py:173-177."""
    m = np.ones((batch, L1), np.float32)
    gap = int(0.025 * fs1)
    for c in (0.25, 0.45, 0.65, 0.85):
        s = int(c * L1)
        m[:, s:s + gap] = 0.0
    return m


@pytest.mark.parametrize("batch,L,fs", [(2, 184184, 22050.0), (1, 184320, 44100.0)])
def test_masks_are_the_jax_benchs(batch, L, fs):
    m = bench_torch.center_gap_mask(batch, L, fs)
    np.testing.assert_array_equal(m, _jax_center_gap(batch, L, fs))
    assert m.dtype == np.float32 and 0 < (m == 0).sum() < m.size
    s = bench_torch.shortgaps_mask(batch, L, fs)
    np.testing.assert_array_equal(s, _jax_shortgaps(batch, L, fs))
    assert (s == 0).sum() == batch * 4 * int(0.025 * fs)


def test_headline_trajectory_matches_the_jax_sampler():
    """The headline leg at the tiny size, two rows, built by the port's
    ``build`` with the JAX bench's weights loaded into it
    (``bundle.init(PRNGKey(0), ...)``, gates redrawn at the main layers'
    scale so every block moves the output), against the JAX sampler of the same composed config; the
    JAX key schedule's noise injected. The 1500 ms gap covers the whole
    2048-sample tiny window (no observed sample: NaN in both packages), so
    the mask is a 20 ms centre gap. f32, tolerance TRAJ_TOL (the sampler
    parity tests')."""
    words = bench_torch.LEGS["headline"] + TINY_WORDS
    jargs = jax_compose(overrides=words)
    L, fs, batch = int(jargs.exp.audio_len), float(jargs.exp.sample_rate), 2
    bundle = asetup.setup_network(jargs)
    bundle.init(jax.random.PRNGKey(0), batch, L)
    bundle.params = trained_like(bundle.params)
    jsampler = asetup.setup_sampler(jargs, network=bundle,
                                    diff_params=asetup.setup_diff_parameters(jargs))
    mask = bench_torch.center_gap_mask(batch, L, fs, gap_ms=20.0)
    y = (np.random.default_rng(0).standard_normal((batch, L)) * 0.063).astype(np.float32) * mask
    key = jax.random.PRNGKey(1)
    ref = np.asarray(jsampler.predict_inpainting(jax.numpy.asarray(y), jax.numpy.asarray(mask),
                                                 key))

    args, sampler, L2, fs2 = bench_torch.build(bench_torch.LEGS["headline"], TINY_WORDS, "cpu")
    sampler.model.load_state_dict(state_dict_from_flax(jax.device_get(bundle.params)))
    assert (L2, fs2) == (L, fs) and int(args.tester.T) == int(jargs.tester.T)
    prior, churn = _jax_noise(key, (batch, L), int(args.tester.T))
    got = sampler.predict_inpainting(torch.from_numpy(y), torch.from_numpy(mask),
                                     prior=torch.from_numpy(prior),
                                     churn=torch.from_numpy(churn)).numpy()
    assert np.isfinite(ref).all() and np.abs(ref[mask == 0]).max() > 0
    err = rel_err(got, ref)
    assert err < TRAJ_TOL, err


def _finished(run, ok=True):
    """(return code, stdout, stderr) of a run, which must exit 0 when ``ok``."""
    p, tmp, name = run
    p.wait(timeout=300)
    out, err = (tmp / f"{name}.log").read_text(), (tmp / f"{name}.err").read_text()
    if ok:
        assert p.returncode == 0, err[-3000:]
    return p.returncode, out, err


def _lines(out):
    """The JSON lines of a run's output."""
    rows = []
    for ln in out.splitlines():
        try:
            rows.append(json.loads(ln))
        except ValueError:
            pass
    return rows


@pytest.mark.parametrize("suite", ["headline", "full"])
def test_bench_runs_and_prints_the_jax_benchs_line(runs, suite):
    _, out, _ = _finished(runs[suite])
    line = json.loads(out.strip().splitlines()[-1])
    assert set(line) == ({"metric", "value", "unit", "vs_baseline"}
                         | ({"extras"} if suite == "full" else set()))
    assert line["metric"] == "inpaint_rtf" and line["unit"] == "x_realtime"
    assert line["value"] > 0
    assert abs(line["vs_baseline"] - line["value"] / 10.0) < 1e-3
    legs = [r for r in _lines(out)[:-1] if "leg" in r]
    assert [r["leg"] for r in legs] == (["headline"] if suite == "headline"
                                        else ["headline", "shortgaps", "uncond", "44k"])
    for r in legs:        # T=2, order 1: one score a step, counted
        assert r["scores_per_trajectory"] == 2 and r["batch"] == 1 and r["T"] == 2, r
        assert len(r["rep_s"]) == 1 and r["card"] == "cpu (no card)"
    if suite == "full":
        ex = line["extras"]
        assert set(ex) == {"shortgaps_rtf", "uncond_rtf", "rtf_44k"}, ex
        assert all(v > 0 for v in ex.values()), ex
        assert not [k for k in ex if k.endswith("_error")]


@pytest.mark.parametrize("name,key", [("dp2", "devices"), ("tp2", "tp")])
def test_two_ranks_print_one_line(runs, name, key):
    _, out, _ = _finished(runs[name])
    lines = [r for r in _lines(out) if "metric" in r]
    assert len(lines) == 1, out[-3000:]
    assert lines[0][key] == 2 and lines[0]["value"] > 0
    assert set(lines[0]) == {"metric", "value", "unit", "vs_baseline", key}
    legs = [r for r in _lines(out) if "leg" in r]
    assert len(legs) == 1 and legs[0][key] == 2 and legs[0]["rows_per_rank"] == 1
    assert legs[0]["batch"] == (2 if key == "devices" else 1)
    assert "arithmetic, not scaling" in legs[0]["ranks"]
    assert ("eager" in legs[0]) == (key == "tp")
    assert out.count("backend gloo") == 2


@pytest.mark.skipif(torch.cuda.is_available(), reason="shows the error raised without CUDA")
def test_without_cuda_the_bench_fails_with_the_ports_error(runs):
    code, out, err = _finished(runs["no_cuda"], ok=False)
    assert code != 0
    assert CUDA_ERROR in err
    assert "inpaint_rtf" not in out
