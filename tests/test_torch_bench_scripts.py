"""The port's measuring scripts against the JAX package's:
``scripts/bench_train_torch.py`` (``scripts/bench_train.py``) and
``scripts/bench_loader_torch.py`` (``scripts/bench_loader.py``), each run on
the CPU at a tiny size; the loader's corpus against the JAX script's, byte
for byte. The script runs start together with the module's first test."""
import importlib.util
import math
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from tests.torch_native import jax_native

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = ["exp=test_cqtdiff_22k", "exp.audio_len=2048", "exp.batch=2",
        "network.cqt.num_octs=3", "network.cqt.bins_per_oct=8", "network.Ns=[8,8,8]",
        "network.num_dils=[1,1,1]", "network.attention_layers=[0,0,0,0]",
        "network.compute_dtype=float32"]
CUDA_ERROR = "aid_tpu_torch runs on a CUDA device"
ENV = {k: v for k, v in os.environ.items() if k != "TRAIN_BENCH_STEPS"}


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _start(tmp, name, script, *args):
    env = dict(ENV, OMP_NUM_THREADS="1", TMPDIR=str(tmp), TRAIN_BENCH_STEPS="1")
    with open(tmp / f"{name}.log", "w") as out, open(tmp / f"{name}.err", "w") as err:
        p = subprocess.Popen([sys.executable, str(ROOT / "scripts" / script), *args], env=env,
                             stdout=out, stderr=err, cwd=str(tmp))
    return p, tmp, name


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench_scripts")
    procs = {"train": _start(tmp, "train", "bench_train_torch.py", *TINY, "--device", "cpu"),
             "loader": _start(tmp, "loader", "bench_loader_torch.py", "--files", "2",
                              "--secs", "20", "--batches", "2")}
    if not torch.cuda.is_available():
        procs["train_no_cuda"] = _start(tmp, "train_no_cuda", "bench_train_torch.py", *TINY)
    yield procs
    for p, _, _ in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def _finished(run):
    p, tmp, name = run
    p.wait(timeout=300)
    return p.returncode, (tmp / f"{name}.log").read_text(), (tmp / f"{name}.err").read_text()


def test_bench_train_prints_the_jax_scripts_lines(runs):
    code, out, err = _finished(runs["train"])
    assert code == 0, err[-3000:]
    lines = out.splitlines()
    assert re.fullmatch(r"first step \(capture\): [\d.]+s", lines[0]), out
    assert lines[1] == "gpu: cpu (no card)"
    m = re.fullmatch(r"train step: ([\d.a-z]+) ms  \(global batch 2, ([\d.]+) s audio/step -> "
                     r"([\d.a-z]+)x realtime\)", lines[2])
    assert m, out
    assert math.isfinite(float(m.group(1))) and float(m.group(1)) > 0
    assert float(m.group(2)) == round(2 * 2048 / 22050, 2)


@pytest.mark.skipif(torch.cuda.is_available(), reason="shows the error raised without CUDA")
def test_bench_train_without_cuda_fails_with_the_ports_error(runs):
    code, out, err = _finished(runs["train_no_cuda"])
    assert code != 0 and CUDA_ERROR in err
    assert "train step" not in out


def test_bench_loader_prints_three_worker_rows(runs):
    code, out, err = _finished(runs["loader"])
    assert code == 0, err[-3000:]
    # the default budget is the port's own step, not a TPU number
    assert "train step budget 631 ms @ batch 4 => need 6.3 segments/s" in out
    rows = re.findall(r"^num_workers=(\d):\s+([\d.]+) batches/s\s+([\d.]+) segments/s\s+"
                      r"([\d.]+)x budget  \[(OK|BOTTLENECK)\]$", out, re.M)
    assert [r[0] for r in rows] == ["0", "2", "4"], out
    assert all(float(r[1]) > 0 for r in rows)


def test_make_corpus_writes_the_jax_scripts_files(tmp_path):
    assert jax_native() is not None      # the JAX package's writer, loaded safely
    jax_script, port_script = _load_script("bench_loader"), _load_script("bench_loader_torch")
    jax_script.make_corpus(str(tmp_path / "jax"), 3, 1.5)
    port_script.make_corpus(str(tmp_path / "port"), 3, 1.5)
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert [str(f) for f in files] == ["2015/file_0.wav", "2015/file_1.wav", "2015/file_2.wav",
                                       "maestro-v3.0.0.csv"]
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*") if p.is_file())
    for f in files:
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes(), f
