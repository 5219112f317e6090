"""The learning gate over trainer seeds, for the JAX package and the PyTorch
port side by side: each of ``scripts/e2e_smoke.py`` (JAX) and
``scripts/e2e_smoke_torch.py`` (the port) runs once per ``exp.seed`` (the
trainer's noise and data-order seed; the network init and the sampler's
noise stay those of the scripts), each in its own process, and the gap-SNR
gain and gap-LSD ratio of every run are printed as a table and as one JSON
line with each package's distribution. ``--init-seeds`` also varies the
network's initialisation and ``--sample-seeds`` the sampler's noise (the
scripts use seeds 0 and 5 in each package's own random streams), so that
the spread over initialisations and sampler draws can be told from the
spread over trainer seeds.

The operating point defaults to the JAX package's CI gate
(tests/test_e2e_smoke.py: SMOKE_L 8192, SMOKE_ITS 150, SMOKE_DTYPE float32);
SMOKE_* variables set in the environment take precedence. Neither script is
changed: a small wrapper appends ``exp.seed=N`` and a per-run ``model_dir``
to the scripts' composed config and keeps every file a run writes (the JAX
script's wavs, its orbax dump is skipped, its compile cache) in that run's
directory under ``--out`` (the JAX script's fixed output directory included).

    python scripts/e2e_seed_sweep.py --seeds 42,1,2,3 --jobs 4 --threads 2
    python scripts/e2e_seed_sweep.py --seeds 42 --init-seeds 0,1,2,3
    python scripts/e2e_seed_sweep.py --packages torch --device cuda   # the port on the card
"""
import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CI_POINT = {"SMOKE_L": "8192", "SMOKE_ITS": "150", "SMOKE_DTYPE": "float32"}

_WRAP_JAX = """
import json, os, sys, runpy
o = json.loads(sys.argv[1])
seed, out = o["seed"], o["out"]
sys.path.insert(0, {repo!r})
_makedirs = os.makedirs
os.makedirs = lambda p, *a, **k: _makedirs(out if p == "/tmp/aid_tpu_smoke" else p, *a, **k)
import jax
jax.config.update("jax_platforms", "cpu")
from aid_tpu.utils import config, logging_utils
_compose, _write = config.compose, logging_utils.write_audio_file
config.compose = lambda *a, overrides=(), **k: _compose(
    *a, overrides=list(overrides) + [f"exp.seed={{seed}}", f"model_dir={{out}}"], **k)
logging_utils.write_audio_file = lambda x, fs, name, path=".", *a, **k: _write(x, fs, name, out, *a, **k)
import orbax.checkpoint as ocp
class _NoDump:
    def save(self, *a, **k):
        pass
ocp.PyTreeCheckpointer = _NoDump
if o["init_seed"] != "default":
    from aid_tpu.models.bundle import NetBundle
    _init = NetBundle.init
    NetBundle.init = lambda self, key, *a, **k: _init(self, jax.random.PRNGKey(int(o["init_seed"])),
                                                      *a, **k)
if o["sample_seed"] != "default":
    from aid_tpu.sampling.sampler import Sampler
    _pi = Sampler.predict_inpainting
    Sampler.predict_inpainting = lambda self, y, m, key: _pi(
        self, y, m, jax.random.PRNGKey(int(o["sample_seed"])))
sys.argv = [sys.argv[0]]
runpy.run_path({script!r}, run_name="__main__")
"""

_WRAP_TORCH = """
import json, sys, runpy
o = json.loads(sys.argv[1])
sys.path.insert(0, {repo!r})
import torch
from aid_tpu_torch.utils import config
_compose = config.compose
config.compose = lambda *a, overrides=(), **k: _compose(
    *a, overrides=list(overrides) + [f"exp.seed={{o['seed']}}"], **k)
if o["init_seed"] != "default":
    from aid_tpu_torch import setup
    _setup_network = setup.setup_network
    setup.setup_network = lambda *a, seed=0, **k: _setup_network(*a, seed=int(o["init_seed"]), **k)
if o["sample_seed"] != "default":
    from aid_tpu_torch.sampling.sampler import Sampler
    _pi = Sampler.predict_inpainting
    Sampler.predict_inpainting = lambda self, y, m, generator=None, **k: _pi(
        self, y, m, generator=torch.Generator(device=y.device).manual_seed(int(o["sample_seed"])),
        **k)
sys.argv = [sys.argv[0], "--device", o["device"]]
runpy.run_path({script!r}, run_name="__main__")
"""

_PATTERNS = {
    "snr_untrained_db": r"gap SNR untrained: (-?[\d.]+) dB",
    "snr_trained_db": r"gap SNR after training: (-?[\d.]+) dB",
    "snr_gain_db": r"gates: snr gain (-?[\d.]+) dB",
    "lsd_gap_ratio": r"gap-LSD ratio (-?[\d.]+) \(max",
    "train_s": r"trained \d+ its in ([\d.]+)s",
}


def parse(text: str) -> dict:
    """The numbers of one run's output (both scripts print the same lines)."""
    row = {}
    for key, pat in _PATTERNS.items():
        m = re.search(pat, text)
        row[key] = float(m.group(1)) if m else None
    row["pass"] = "E2E SMOKE PASS" in text
    return row


def run_one(package: str, init_seed: str, sample_seed: str, seed: int, out: str, threads: int,
            device: str) -> dict:
    d = os.path.join(out, f"{package}-init{init_seed}-sample{sample_seed}-seed{seed}")
    os.makedirs(d, exist_ok=True)
    env = dict(os.environ)
    for k, v in CI_POINT.items():
        env.setdefault(k, v)
    env.update({"HOME": d, "TMPDIR": d, "OMP_NUM_THREADS": str(threads),
                "MKL_NUM_THREADS": str(threads), "OPENBLAS_NUM_THREADS": str(threads)})
    if package == "jax":
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_eigen=false "
                            f"intra_op_parallelism_threads={threads}").strip()
        code = _WRAP_JAX.format(repo=REPO, script=os.path.join(REPO, "scripts", "e2e_smoke.py"))
    else:
        code = _WRAP_TORCH.format(repo=REPO,
                                  script=os.path.join(REPO, "scripts", "e2e_smoke_torch.py"))
    opts = {"seed": seed, "out": d, "init_seed": init_seed, "sample_seed": sample_seed,
            "device": device}
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(opts)], env=env, cwd=d,
                          capture_output=True, text=True)
    text = proc.stdout + proc.stderr
    with open(os.path.join(d, "log.txt"), "w") as f:
        f.write(text)
    row = {"package": package, "init_seed": init_seed, "sample_seed": sample_seed, "seed": seed,
           "rc": proc.returncode,
           "wall_s": time.time() - t0, **parse(text)}
    print(json.dumps(row), flush=True)
    return row


def summary(rows: list) -> dict:
    """Each package's gain and LSD-ratio distribution over its seeds."""
    out = {}
    for pkg in sorted({r["package"] for r in rows}):
        rs = [r for r in rows if r["package"] == pkg and r["snr_gain_db"] is not None]
        gains = [r["snr_gain_db"] for r in rs]
        ratios = [r["lsd_gap_ratio"] for r in rs]
        out[pkg] = {"n": len(rs), "passed": sum(r["pass"] for r in rs),
                    "gain_db": {"min": min(gains, default=None), "max": max(gains, default=None),
                                "mean": statistics.fmean(gains) if gains else None,
                                "sd": statistics.stdev(gains) if len(gains) > 1 else None},
                    "lsd_ratio": {"min": min(ratios, default=None),
                                  "max": max(ratios, default=None),
                                  "mean": statistics.fmean(ratios) if ratios else None}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="42,1,2,3", help="exp.seed values, comma-separated")
    ap.add_argument("--init-seeds", default="default",
                    help="network init seeds, comma-separated (default: the scripts' own)")
    ap.add_argument("--sample-seeds", default="default",
                    help="sampler noise seeds, comma-separated (default: the scripts' own)")
    ap.add_argument("--packages", default="jax,torch", help="jax, torch or both")
    ap.add_argument("--jobs", type=int, default=2, help="runs at a time")
    ap.add_argument("--threads", type=int, default=2, help="CPU threads per run")
    ap.add_argument("--device", default="cpu", help="the port's device (the JAX runs use the CPU)")
    ap.add_argument("--out", default=os.path.join(REPO, "experiments", "e2e_seed_sweep"))
    a = ap.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",")]
    jobs = [(p, i, n, s) for i in a.init_seeds.split(",") for n in a.sample_seeds.split(",")
            for s in seeds for p in a.packages.split(",")]
    with ThreadPoolExecutor(a.jobs) as pool:
        rows = list(pool.map(lambda j: run_one(*j, a.out, a.threads, a.device), jobs))
    print("\n| package | init seed | sampler seed | exp.seed | gap SNR untrained | trained "
          "| gain (dB) | gap-LSD ratio | gate |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['package']} | {r['init_seed']} | {r['sample_seed']} | {r['seed']} "
              f"| {r['snr_untrained_db']} "
              f"| {r['snr_trained_db']} "
              f"| {r['snr_gain_db']} | {r['lsd_gap_ratio']} | {'PASS' if r['pass'] else 'FAIL'} |")
    print(json.dumps({"e2e_seed_sweep": {"operating_point": {k: os.environ.get(k, v)
                                                             for k, v in CI_POINT.items()},
                                         "device": a.device, "rows": rows,
                                         "summary": summary(rows)}}))
    return 0 if all(r["rc"] in (0, 1) and r["snr_gain_db"] is not None for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
