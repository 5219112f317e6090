"""The port's learning gate (slow tier): ``scripts/e2e_smoke_torch.py`` on
the CPU at the JAX package's CI operating point (tests/test_e2e_smoke.py:
SMOKE_L 8192, 150 iterations, f32, gap-SNR gain >= 4.0 dB, gap-LSD ratio
<= 0.95) must print E2E SMOKE PASS. The script enforces the gates; this
test pins the operating point and reads the verdict."""
import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_e2e_smoke_torch_quality_gate(tmp_path):
    env = dict(os.environ)
    env.update({"SMOKE_DTYPE": "float32", "SMOKE_L": "8192", "SMOKE_ITS": "150",
                "SMOKE_MIN_SNR_GAIN_DB": "4.0", "SMOKE_MAX_LSD_RATIO": "0.95",
                "TMPDIR": str(tmp_path)})
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "e2e_smoke_torch.py"),
                           "--device", "cpu"], env=env, capture_output=True, text=True,
                          timeout=3600)
    tail = "\n".join((proc.stdout + proc.stderr).splitlines()[-25:])
    assert proc.returncode == 0, f"e2e smoke failed:\n{tail}"
    assert "E2E SMOKE PASS" in proc.stdout, tail
