"""The readings the limits of ``correct`` are set from, on the card: for
each seed, a run of the cell over one unit (its set-up, the unit, then the
numbers compared with the float32 reference), for the program and, on the
control seeds, for the configuration's lower-precision path in its place
(the reference is computed once a seed). A cell on one card runs in this
process; a cell over several cards runs each reading as a process of its
own (``--one``), with its ranks. Not run by the benchmark's runs.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... [--control-seeds 1 2 3]
    python3 benchmark/calibrate.py --one <program|control|fault> [--device cpu] <run.py's arguments>

Prints one JSON line a reading: the seed, "program", "control" or the
fault planted, the harness's ``correct``, each number compared, the set-up
seconds and the run's. ``--fault`` plants one of ``FAULTS`` in the program on the
control seeds instead of running the control. ``--one`` is one run of the
harness as ``run.py`` makes it, with the program, the control or a fault in
every rank, on the card or (for the tests) the CPU.
"""
import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


def altered(run):
    """A sampler's answer altered where it is produced: its first row shifted."""
    def wrapped(self, *a, **k):
        x = run(self, *a, **k).clone()
        x[0] += 0.05 * x[0].abs().max()
        return x
    return wrapped


def half_rows(run):
    """Half of a trajectory's rows left out: the second half a copy of the first."""
    def wrapped(self, *a, **k):
        x = run(self, *a, **k).clone()
        n = max(1, x.shape[0] // 2)
        x[n:] = x[:x.shape[0] - n]
        return x
    return wrapped


def half_batch(backward):
    """A training step on half of its batch, the mean taken over the rest."""
    def wrapped(self, x, draws, model):
        n = x.shape[1] // 2
        return backward(self, x[:, :n], {k: v[:, :n] for k, v in draws.items()}, model)
    return wrapped


def state_kept(update):
    """A training step that returns its state unchanged (its loss computed):
    the update, on one card and in the dp step's tail, left out."""
    return lambda self, grads, keep, loss, bins, moments: {"loss": loss}


def ema_kept(update):
    """A training step that leaves the EMA unchanged (the rest of it sound)."""
    return lambda self, grads, keep, *stats: update(self, grads, keep * 0, *stats)


def exchange_left_out(reduce):
    """A dp step whose gradient all-reduce between the ranks is left out."""
    return lambda self, flat: None


def _sampler():
    from aid_tpu_torch.sampling.program import HeunProgram
    return HeunProgram, "run"


def _trainer(name):
    def where():
        from aid_tpu_torch.training.trainer import Trainer
        return Trainer, name
    return where


# name: (what it replaces, the fault around it)
FAULTS = {"altered": (_sampler, altered), "half_rows": (_sampler, half_rows),
          "half_batch": (_trainer("_backward"), half_batch),
          "state_kept": (_trainer("_update"), state_kept),
          "ema_kept": (_trainer("_update"), ema_kept),
          "exchange_left_out": (_trainer("_dp_reduce"), exchange_left_out)}


@contextlib.contextmanager
def planted(fault):
    """The program with the named fault planted, undone on exit."""
    if fault is None:
        yield
        return
    where, wrap = FAULTS[fault]
    owner, name = where()
    original = getattr(owner, name)
    setattr(owner, name, wrap(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def readings(workload: str, seeds, control_seeds, device, cell=None, cfg=None, mix=None,
             fault=None):
    """Yield one reading a (seed, path), each a run of the cell through
    ``harness.run_cell`` over one unit: the program's on ``seeds``, the
    control's (or, with ``fault``, the faulty program's) on ``control_seeds``."""
    import harness
    cell = cell if cell is not None else harness.load_json("workloads", workload)
    cache = {}
    runs = [(s, False) for s in seeds] + [(s, True) for s in control_seeds]
    runs.sort(key=lambda r: (r[0], r[1]))          # a seed's two paths share its reference
    for seed, control in runs:
        t0 = time.perf_counter()
        path = (fault or "control") if control else "program"
        if int(cell.get("chips", 1)) > 1:
            if cfg is not None or mix is not None:
                raise ValueError("a cell over several cards runs from its files")
            yield _process(workload, seed, path, device)
            continue
        try:
            with planted(fault if control else None):
                line = harness.run_cell(workload, seed, 0.0, False, device, t0, cell=cell,
                                        cfg=cfg, mix=mix, control=control and not fault,
                                        reference_cache=cache)
        except Exception as e:      # a control that crashes has failed and sets no reading
            yield {"seed": seed, "path": path, "correct": False, "error": repr(e)}
            continue
        yield _reading(seed, path, line, t0)


def _reading(seed: int, path: str, line: dict, t0: float) -> dict:
    return {"seed": seed, "path": path, "correct": line["correct"],
            "numbers": {k: c["value"] for k, c in line["checks"].items()},
            "setup_s": line["metrics"]["setup_s"]["value"], "run_s": time.perf_counter() - t0}


def _process(workload: str, seed: int, path: str, device) -> dict:
    """One reading of a cell over several cards: a run of ``--one`` over one unit."""
    t0 = time.perf_counter()
    cmd = [sys.executable, os.path.abspath(__file__), "--one", path,
           *(["--device", device.type] if device.type != "cuda" else []),
           "--workload", workload, "--seed", str(seed), "--seconds", "0", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=1800)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        return {"seed": seed, "path": path, "correct": False,
                "error": f"exit {out.returncode}: {out.stderr[-3000:]}"}
    return _reading(seed, path, json.loads(lines[-1]), t0)


def one(argv) -> int:
    """``--one``: one run of the harness with the program, the control or a
    planted fault (in this process and in every rank it starts)."""
    import torch

    import harness
    p = argparse.ArgumentParser()
    p.add_argument("--one", required=True, choices=["program", "control", *sorted(FAULTS)])
    p.add_argument("--device")
    a, rest = p.parse_known_args(argv)
    entry = [os.path.abspath(__file__), "--one", a.one] + (["--device", a.device] if a.device else [])
    with planted(a.one if a.one in FAULTS else None):
        return harness.main(rest, time.perf_counter(), entry,
                            device=torch.device(a.device) if a.device else None,
                            control=a.one == "control")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--one" in argv:
        return one(argv)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", choices=sorted(FAULTS))
    a = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibration runs on a CUDA card", file=sys.stderr)
        return 2
    for r in readings(a.workload, a.seeds, a.control_seeds, torch.device("cuda"), fault=a.fault):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
