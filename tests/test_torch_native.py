"""The test helper that loads the JAX package's native audio library
(``tests/torch_native.py``): four processes started together on a fresh
copy of the sources all load the library one of them built; a load that
fails while another process writes the file is retried; a process whose
``aid_tpu.data.audio_io`` gave up after such a failure gets the library.
"""
import os
import shutil
import subprocess
import sys
import time

import pytest

from aid_tpu.data import audio_io as jaudio
from tests import torch_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = """
import os, sys, time
from tests.torch_native import build_and_load
native, go = sys.argv[1], sys.argv[2]
while not os.path.exists(go):
    time.sleep(0.005)
lib = build_and_load(native)
assert hasattr(lib, "aio_flac_info") and hasattr(lib, "aio_resample")
print("loaded")
"""


def test_four_processes_load_one_fresh_build(tmp_path):
    native = tmp_path / "native"
    native.mkdir()
    for s in torch_native.SOURCES:
        shutil.copy(os.path.join(torch_native.JAX_NATIVE_DIR, s), native / s)
    go = tmp_path / "go"
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(native), str(go)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    time.sleep(0.5)          # every process waiting on the same start
    go.write_text("")
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == "loaded", err
    assert (native / torch_native.LIB).stat().st_size > 0
    assert not [f for f in os.listdir(native) if f.endswith(".so.tmp")]


def test_a_failed_load_is_retried(tmp_path):
    (tmp_path / torch_native.LIB).write_bytes(b"")       # as if being written in place
    calls = []

    def load():
        calls.append(time.monotonic())
        if len(calls) < 3:
            raise OSError("libaudioio.so: file too short")
        return "lib"

    assert torch_native.build_and_load(str(tmp_path), load) == "lib"
    assert len(calls) == 3


def test_a_load_that_keeps_failing_raises_its_error(tmp_path):
    (tmp_path / torch_native.LIB).write_bytes(b"")

    def load():
        raise OSError("libaudioio.so: file too short")

    with pytest.raises(OSError, match="file too short"):
        torch_native.build_and_load(str(tmp_path), load, timeout_s=0.2)


def test_jax_native_recovers_a_module_that_gave_up(monkeypatch):
    """The state ``_native`` leaves after loading a half-written file:
    tried, no library."""
    monkeypatch.setattr(jaudio, "_NATIVE", None)
    monkeypatch.setattr(jaudio, "_NATIVE_TRIED", True)
    assert jaudio._native() is None
    lib = torch_native.jax_native()
    assert lib is not None and jaudio._native() is lib
