"""The port's shell launchers (``scripts/*_torch.sh``) against the JAX
package's (``scripts/training.sh``, ``testing.sh``, ``testing_shortgaps.sh``).

A launcher's override words are read by running it with a stand-in
interpreter that prints its arguments, one per line (bash does the
quoting and the expansion of ``MODEL_DIR`` and ``CKPT``); a marker passed
as the launcher's own argument shows where ``"$@"`` lands. The words of a
twin must be its JAX launcher's, and both packages must compose them into
the same tree. Then the training launcher runs for real on the CPU with
``dry_run=True``: under ``torch.distributed.run`` with two ranks, and as
two localhost nodes that rendezvous. Without CUDA every twin exits
non-zero with the port's own error: no launcher falls back to the CPU.
"""
import json
import os
import pathlib
import re
import socket
import subprocess
import sys
import types

import pytest
import torch

from aid_tpu.utils.config import compose as jax_compose
from aid_tpu_torch.utils.config import compose
from tests.test_torch_config import _flatten, _plain

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
MARKER = "launcher.marker=1"
CKPT = "experiments/run/22k_8s-7.pt"
# (JAX launcher, the port's twin, the module the twin runs)
PAIRS = [("training.sh", "training_torch.sh", "aid_tpu_torch.train"),
         ("testing.sh", "testing_torch.sh", "aid_tpu_torch.test"),
         ("testing_shortgaps.sh", "testing_shortgaps_torch.sh", "aid_tpu_torch.test")]
# keys of a launcher's tree that only the port's files carry, with their
# values: the port's exp files all carry the trainer keys of maestro22k_8s,
# at the JAX trainer's defaults where the JAX file has none
# (tests/test_torch_config.py, PORT_ONLY)
PORT_ONLY = {
    "training.sh": {},
    "testing.sh": {},
    "testing_shortgaps.sh": {"exp.skip_grad_norm": 0, "exp.skip_grad_factor": 0,
                             "exp.stall_timeout_s": 1800, "exp.max_host_rss_gb": 0},
}
CUDA_ERROR = "aid_tpu_torch runs on a CUDA device"
# the launchers' knobs: each test sets those it means, none leaks in
KNOBS = ("MODEL_DIR", "CKPT", "NPROC", "NNODES", "NODE_RANK", "MASTER_ADDR", "MASTER_PORT",
         "PYTHON")
ENV = {k: v for k, v in os.environ.items() if k not in KNOBS}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def echo(tmp_path):
    """A directory holding ``python`` and ``python3`` that print their
    arguments, one per line."""
    d = tmp_path / "bin"
    d.mkdir()
    for name in ("python", "python3"):
        p = d / name
        p.write_text("#!/bin/sh\nprintf '%s\\n' \"$@\"\n")
        p.chmod(0o755)
    return d


def _argv(script, echo, tmp_path, **env):
    """The arguments a launcher hands its interpreter (the stand-in's)."""
    env = dict(ENV, PATH=f"{echo}{os.pathsep}{ENV['PATH']}",
               PYTHON=str(echo / "python3"), MODEL_DIR=str(tmp_path / "md"), **env)
    out = subprocess.run(["bash", str(SCRIPTS / script), MARKER], env=env, check=True,
                         capture_output=True, text=True, timeout=60)
    return out.stdout.splitlines()


def _overrides(argv, entry):
    """The words between the entry (``train.py`` or ``-m <module>``) and
    ``"$@"``."""
    start = argv.index(entry) + 1
    assert argv[-1] == MARKER and argv.count(MARKER) == 1
    return argv[start:-1]


def _tree(c, words):
    return _flatten(_plain(c(overrides=words)))


@pytest.mark.parametrize("jax_sh,port_sh,module", PAIRS, ids=[p[1] for p in PAIRS])
def test_twin_composes_the_jax_launchers_tree(jax_sh, port_sh, module, echo, tmp_path):
    jax_words = _overrides(_argv(jax_sh, echo, tmp_path, CKPT=CKPT),
                           "train.py" if jax_sh == "training.sh" else "test.py")
    argv = _argv(port_sh, echo, tmp_path, CKPT=CKPT)
    assert argv[:2] == ["-m", module]
    port_words = _overrides(argv, module)
    assert port_words == jax_words
    assert f"model_dir={tmp_path / 'md'}" in port_words
    assert (f"tester.checkpoint={CKPT}" in port_words) == (jax_sh != "training.sh")
    assert [w.split("=")[0] for w in port_words][1:] == (
        ["dset", "exp", "network", "tester", "logging"] if jax_sh == "training.sh"
        else ["dset", "exp", "network", "tester", "tester.checkpoint"])

    ref, port = _tree(jax_compose, jax_words), _tree(compose, port_words)
    only = {k: port.pop(k) for k in set(port) - set(ref)}
    assert only == PORT_ONLY[jax_sh]
    assert set(port) == set(ref)
    for key, value in ref.items():
        if key.endswith("callable"):
            assert value.startswith("aid_tpu.") and port[key] == "aid_tpu_torch." + value[8:]
        else:
            assert port[key] == value, key


@pytest.mark.parametrize("port_sh,module", [p[1:] for p in PAIRS], ids=[p[1] for p in PAIRS])
def test_twin_runs_the_port_only(port_sh, module):
    text = (SCRIPTS / port_sh).read_text()
    assert f"-m {module} " in text
    for word in ("train.py", "test.py", "aid_tpu.", "aid_tpu/"):
        assert word not in text, word
    assert not re.search(r"\bjax\b", text, re.IGNORECASE)


def test_training_launcher_goes_through_torchrun(echo, tmp_path):
    argv = _argv("training_torch.sh", echo, tmp_path, NPROC="2")
    head = ["-m", "torch.distributed.run", "--nnodes", "1", "--node-rank", "0",
            "--nproc-per-node", "2", "--master-addr", "127.0.0.1", "--master-port", "29500",
            "-m", "aid_tpu_torch.train"]
    assert argv[:len(head)] == head
    assert argv[-3:] == ["exp.mesh.dp=2", "exp.mesh.distributed=true", MARKER]


def _run_training(tmp_path, name, **env):
    """``scripts/training_torch.sh dry_run=True`` under this interpreter,
    each rank's output in a file of its own (torch.distributed.run's
    PET_LOG_DIR / PET_REDIRECTS)."""
    logs = tmp_path / f"logs_{name}"
    env = dict(ENV, PYTHON=sys.executable, MODEL_DIR=str(tmp_path / "md"),
               PET_LOG_DIR=str(logs), PET_REDIRECTS="3", **env)
    proc = subprocess.Popen(["bash", str(SCRIPTS / "training_torch.sh"), "dry_run=True"],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, logs


def _rank_trees(proc, logs):
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0, out[-4000:]
    trees = {}
    for f in sorted(logs.rglob("stdout.log")):
        text = f.read_text()
        trees[f.parent.name] = json.loads(text[text.index("\n{") + 1:])
    return trees


def test_training_launcher_starts_two_ranks(tmp_path):
    proc, logs = _run_training(tmp_path, "nproc2", NPROC="2", MASTER_PORT=str(_free_port()))
    trees = _rank_trees(proc, logs)
    assert sorted(trees) == ["0", "1"]
    for tree in trees.values():
        assert tree["exp"]["mesh"]["dp"] == 2 and tree["exp"]["mesh"]["distributed"] is True
        assert tree["model_dir"] == str(tmp_path / "md") and tree["dry_run"] is True


def test_training_launcher_two_nodes_rendezvous(tmp_path):
    port = str(_free_port())
    nodes = [_run_training(tmp_path, f"node{r}", NNODES="2", NODE_RANK=str(r),
                           MASTER_PORT=port) for r in (0, 1)]
    try:
        for proc, logs in nodes:
            trees = _rank_trees(proc, logs)
            assert list(trees) == ["0"]
            assert trees["0"]["exp"]["mesh"]["dp"] == 2
            assert trees["0"]["exp"]["mesh"]["distributed"] is True
    finally:
        for proc, _ in nodes:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@pytest.mark.skipif(torch.cuda.is_available(), reason="shows the error raised without CUDA")
@pytest.mark.parametrize("port_sh", [p[1] for p in PAIRS])
def test_twin_without_cuda_exits_with_the_ports_error(port_sh, tmp_path):
    env = dict(ENV, PYTHON=sys.executable, MODEL_DIR=str(tmp_path / "md"))
    out = subprocess.run(["bash", str(SCRIPTS / port_sh)], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert CUDA_ERROR in out.stderr
    assert not (tmp_path / "md" / "test").exists()


def test_empty_ckpt_means_none_given_in_both_packages(echo, tmp_path):
    from aid_tpu.testing.tester import Tester as JaxTester
    from aid_tpu_torch.testing.tester import Tester
    for jax_sh, port_sh, module in PAIRS[1:]:
        jax_words = _overrides(_argv(jax_sh, echo, tmp_path, CKPT=""), "test.py")
        port_words = _overrides(_argv(port_sh, echo, tmp_path, CKPT=""), module)
        assert "tester.checkpoint=" in jax_words and "tester.checkpoint=" in port_words
        for cls, c, words in ((JaxTester, jax_compose, jax_words), (Tester, compose, port_words)):
            t = c(overrides=words).tester
            assert t.checkpoint is None
            assert cls.load_checkpoint(types.SimpleNamespace(t=t)) is False
