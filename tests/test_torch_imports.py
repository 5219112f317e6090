"""The PyTorch port imports no JAX and nothing of the JAX package: every
module under aid_tpu_torch/ (the data loaders and the native audio loader
included), and chip_smoke.py, is scanned by AST; and a process that reads,
decodes and resamples audio through the port loads no library of the JAX
package."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "aid_tpu")
# the port, chip_smoke.py, its bench, the port's scripts and demo, and the ranks the
# parallel tests spawn (they must not start JAX beside the test process's
# eight fake devices)
SOURCES = (sorted((ROOT / "aid_tpu_torch").rglob("*.py"))
           + [ROOT / "chip_smoke.py", ROOT / "bench_torch.py", ROOT / "tests/torch_dist_worker.py",
              ROOT / "examples/demo_inpainting_torch.py"]
           + sorted((ROOT / "scripts").glob("*_torch.py")))


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name):
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_sources_exist():
    assert len(SOURCES) > 10 and all(p.exists() for p in SOURCES)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_aid_tpu_import(path):
    bad = [n for n in _imported(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("name,bad", [("jax.numpy", True), ("aid_tpu.ops", True),
                                      ("aid_tpu_torch.ops", False), ("torch", False),
                                      ("flax.linen", True)])
def test_scan_classifies_names(name, bad):
    assert _forbidden(name) is bad


def test_new_modules_are_scanned():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {"aid_tpu_torch/data/audio_io.py", "aid_tpu_torch/data/librispeech.py",
            "aid_tpu_torch/serving.py", "aid_tpu_torch/parallel/mesh.py",
            "aid_tpu_torch/parallel/ring_attention.py", "aid_tpu_torch/parallel/tp.py",
            "tests/torch_dist_worker.py", "aid_tpu_torch/utils/summary.py",
            "aid_tpu_torch/utils/io.py", "examples/demo_inpainting_torch.py",
            "scripts/e2e_smoke_torch.py", "scripts/eval_checkpoints_torch.py",
            "scripts/eval_gap_sweep_torch.py", "scripts/make_synth_corpus_torch.py",
            "scripts/parity_vs_reference_torch.py", "scripts/serve_bench_torch.py",
            "scripts/train_report_torch.py", "bench_torch.py", "scripts/bench_train_torch.py",
            "scripts/bench_loader_torch.py"} <= names


def test_the_orbax_converter_is_jax_side_only():
    """scripts/orbax_to_stream.py converts with the JAX package and imports
    nothing of the port."""
    names = list(_imported(ROOT / "scripts/orbax_to_stream.py"))
    assert not any(n.split(".")[0] == "aid_tpu_torch" for n in names)
    assert "aid_tpu.utils" in names


PROBE = """
import sys, numpy as np
from aid_tpu_torch.data import audio_io
from tests import flac_fixture as ff
out = sys.argv[1]
ff.encode(out + "/a.flac", [np.arange(2000) % 300], 16000)
audio_io.write(out + "/a.wav", np.zeros(100, np.float32), 48000)
audio_io.read(out + "/a.flac"), audio_io.read(out + "/a.wav")
audio_io.resample_host(np.ones(4800, np.float32), 48000, 44100)
print(audio_io.native_status())
print([m for m in sys.modules if m.split(".")[0] in ("aid_tpu", "jax")])
print(open("/proc/self/maps").read())
"""


def test_the_native_audio_path_loads_only_the_ports_library(tmp_path):
    """The port's library is its own build (under aid_tpu_torch/native/build),
    and nothing of aid_tpu/ is imported or mapped into the process."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", PROBE, str(tmp_path)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300, check=True)
    status, modules, maps = r.stdout.split("\n", 2)
    assert status.startswith("loaded ") and "aid_tpu_torch/native/build/libaudioio-" in status
    assert modules == "[]"
    assert "aid_tpu_torch/native/build/libaudioio-" in maps
    assert str(ROOT / "aid_tpu" / "native") not in maps
