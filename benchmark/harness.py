"""The benchmark's runner: finds a cell's files by name, runs its set-up, its
measured window of whole units and, with ``--trace 1``, a profile of some
of those units; then decides ``correct`` against the plain reference and
prints the result's line. A cell over several cards runs as that many
processes, one a card (``ranks.py``): rank 0 owns the window, profiles and
prints; the per-layer readings are rank 0's.

Files, each found by name:
  workloads/<cell>.json    {"config", "traffic", "chips", "limits"}
  configs/<config>.json    the configuration (its architecture, config words, sizes, settings)
  traffic/<traffic>.json   {"kind", the kind's parameters, optionally "family"}
  kinds/<kind>.py          set-up, one unit of work, the output check
  metrics/<metric>.py      read(ctx) -> number or None, one per-layer metric
  reference/<architecture>.py, work/<architecture>.py
                           the plain reference net, the work of its forward
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import sys
import time
import traceback
from typing import Dict, List, Optional, Sequence

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "aid_tpu")


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_module(kind: str):
    return load_module(os.path.join(HERE, "kinds", f"{kind}.py"), f"bench_kind_{kind}")


def twin(name: str, family: str):
    """(``UNIT``, ``read``) of a reader that reads as ``metrics/<name>.py``
    does, in the cells of ``family`` alone: one quantity under a name of
    each family, where the families' cells report different end-to-end
    metrics (``mfu.dp`` reads as ``mfu.train``)."""
    base = load_module(os.path.join(HERE, "metrics", f"{name}.py"), "bench_twin_" + name.replace(".", "_"))
    own = name.rsplit(".", 1)[1]

    def read(ctx):
        return base.read({**ctx, "family": own}) if ctx["family"] == family else None
    return base.UNIT, read


def metric_readers() -> Dict[str, object]:
    """{metric name: its reader module} of every file under metrics/."""
    d = os.path.join(HERE, "metrics")
    return {f[:-3]: load_module(os.path.join(d, f), "bench_metric_" + f[:-3].replace(".", "_"))
            for f in sorted(os.listdir(d)) if f.endswith(".py")}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the benchmark may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@contextlib.contextmanager
def span(name: str):
    """A harness span: a profiler range named ``bench.<name>`` (nearly free
    when no profiler runs)."""
    import torch
    with torch.profiler.record_function("bench." + name):
        yield


class Window:
    """Whole units back to back: a unit starts only while the slowest unit so
    far would still end within ``seconds`` of the first unit's start; the
    window runs from the first unit's start to the last unit's end."""

    def __init__(self, seconds: float, at_least: int = 1):
        self.seconds, self.at_least = float(seconds), at_least
        self.starts: List[float] = []
        self.ends: List[float] = []

    def more(self, now: float) -> bool:
        if len(self.starts) < self.at_least:
            return True
        longest = max(e - s for s, e in zip(self.starts, self.ends))
        return now - self.starts[0] + longest <= self.seconds

    def add(self, start: float, end: float) -> None:
        self.starts.append(start)
        self.ends.append(end)

    @property
    def wall(self) -> float:
        return self.ends[-1] - self.starts[0] if self.ends else 0.0

    @property
    def count(self) -> int:
        return len(self.ends)


def device_info(device, chips: int, peak: int) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": chips, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": peak}


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30,
                              check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"no power limit read ({e!r})"


class PeakMemory:
    """The most bytes the process's allocator held on the card over the run
    (its reserved peak, which covers the graph pools that replays write
    into). The program's graph captures reset the allocator's peak, so each
    reset first folds the peak so far in here."""

    def __init__(self, device):
        import torch
        self.device, self.peak = device, 0
        if device.type == "cuda":
            reset = torch.cuda.reset_peak_memory_stats

            def folding_reset(dev=None):
                self.read()
                reset(dev)

            self.reset = reset
            torch.cuda.reset_peak_memory_stats = folding_reset

    def read(self) -> int:
        import torch
        if self.device.type == "cuda":
            self.peak = max(self.peak, int(torch.cuda.max_memory_reserved(self.device)))
        return self.peak

    def close(self) -> int:
        """The peak, with the allocator's own reset put back."""
        import torch
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats = self.reset
        return self.read()


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, cell: Optional[dict] = None, cfg: Optional[dict] = None,
             mix: Optional[dict] = None, control: bool = False,
             reference_cache: Optional[dict] = None, group=None) -> Optional[dict]:
    """One run of a cell; returns the result's line as a dict (``checks``
    last). ``cell``, ``cfg`` and ``mix`` replace the files of that name
    (the tests' tiny sizes). ``control`` puts the configuration's
    lower-precision path in the program's place, and ``reference_cache``
    keeps the reference's outputs across runs of one process (both for
    ``calibrate.py``). ``group``: this process's ``ranks.Ranks`` in a cell
    over several cards; a rank other than 0 follows rank 0's window,
    reports to it and returns None."""
    from devtrace import Profile
    from work import peaks

    cell = cell if cell is not None else load_json("workloads", cell_name)
    cfg = cfg if cfg is not None else load_json("configs", cell["config"])
    mix = mix if mix is not None else load_json("traffic", cell["traffic"])
    kind = kind_module(mix["kind"])
    # the family the cell's metrics belong to: the kind's, or the one its
    # traffic names; a family of its own reports each end-to-end metric as
    # ``<metric>.<family>`` and its own readers
    family = mix.get("family", kind.FAMILY)
    memory = PeakMemory(device)
    bench = kind.Bench(cfg, mix, int(seed), device, control=control)
    bench.reference_cache = reference_cache

    lead = group is None or group.rank == 0
    trace = trace and lead
    window = Window(seconds, at_least=1 + (kind.TRACE_UNITS if trace else 0))
    traced = range(1, 1 + kind.TRACE_UNITS) if trace else range(0)
    profile = Profile(device) if trace else None
    before = after = None
    failed = 0
    setup_s = None
    i = 0
    while group.agree(i, window.more(time.perf_counter())) if group is not None \
            else window.more(time.perf_counter()):
        if i == traced.start and profile is not None:
            before = bench.counters()
            profile.start()
        start = time.perf_counter()
        if setup_s is None:
            setup_s = start - t_start
        try:
            with span("unit"):
                bench.unit(i)
        except Exception as e:      # a unit that fails is counted and ends the window
            if not lead:            # a rank's failure ends the run (rank 0 sees it exit)
                raise
            print(f"unit {i} failed: {e!r}", file=sys.stderr)
            failed += 1
            died = group.abort() if group is not None else None
            if died:
                raise RuntimeError(f"a rank died: {died}") from e
            break
        window.add(start, time.perf_counter())
        i += 1
        if profile is not None and i == traced.stop:
            profile.stop()
            after = bench.counters()
    if profile is not None and profile.running:
        profile.stop()
        after = bench.counters()
    peak = memory.close()
    if not lead:
        group.report(peak, window.count)
        return None
    attempted = window.count + failed
    out_of_step = None
    if group is not None:       # every rank's peak and units, the children gone
        rank_peaks, units = group.gather()
        peak = max([peak] + rank_peaks)
        out_of_step = sum(u != window.count for u in units) if not failed else group.world - 1
        gone = group.close()
        if gone:
            raise RuntimeError(f"a rank ended badly: {gone}")

    metrics = {}
    if trace:
        ctx = dict(family=family, cfg=cfg, mix=mix, bench=bench,
                   chips=int(cell.get("chips", 1)),
                   profile=profile.summary() if profile is not None and after is not None else None,
                   counters={k: after[k] - before[k] for k in after} if after else {},
                   built=bench.built())
        for name, reader in metric_readers().items():
            value = reader.read(ctx)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": reader.UNIT}
    else:
        if window.count:
            for name, m in bench.end_to_end(window.count, window.wall).items():
                metrics[name if family == kind.FAMILY else f"{name}.{family}"] = m
        metrics["setup_s"] = {"value": float(setup_s if setup_s is not None else time.perf_counter() - t_start),
                              "unit": "s"}

    limits = cell.get("limits", {})
    t_check = time.perf_counter()
    checks = bench.check(limits) if window.count else {}
    if out_of_step is not None:     # no rank ran a unit that another skipped
        checks["ranks_out_of_step"] = {"value": out_of_step, "limit": 0}
    units = [round(e - s, 4) for s, e in zip(window.starts, window.ends)]
    print(f"set-up {setup_s or 0.0:.3f} s, window {window.count} units in {window.wall:.3f} s "
          f"(units {units[:8]}{' ...' if len(units) > 8 else ''}), "
          f"check {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    correct = failed == 0 and window.count > 0 and all(
        c["value"] == c["value"] and c["value"] <= c["limit"] for c in checks.values())
    line = {"correct": bool(correct), "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device_info(device, int(cell.get("chips", 1)), peak)}
    if trace and profile is not None and after is not None:
        s = profile.summary()
        print(f"trace: {s['device_events']} device events, busy {s['busy_s']:.3f} s of "
              f"{s['window_s']:.3f} s; {card_line()}; peaks {peaks.describe()}", file=sys.stderr)
        line["device"]["busy_s"] = s["busy_s"]
        line["device"]["window_s"] = s["window_s"]
        line["breakdown"] = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
    line["checks"] = checks
    return line


def parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of the benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float, entry: Sequence[str], device=None, control: bool = False) -> int:
    """One run from the command line; returns the exit code. ``entry``: what
    follows the interpreter in the command that started this run (a cell
    over several cards starts its other ranks with it and ``argv``);
    ``device`` and ``control`` serve ``calibrate.py`` and the tests (the
    CPU in place of the card, the control in place of the program)."""
    args = parse(argv)
    cell = load_json("workloads", args.workload)
    import torch
    chips = int(cell.get("chips", 1))
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"the cell {args.workload} needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            return 2
        device = torch.device("cuda")
    torch.set_num_threads(4)
    if chips == 1:
        return _report(run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device,
                                t_start, cell=cell, control=control))
    import port
    import ranks
    group = ranks.Ranks.join() if ranks.is_child() else \
        ranks.Ranks.launch(chips, [sys.executable, *entry, *argv])
    code = 1
    try:
        device = group.device(device)
        port.init_group(device)
        line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device, t_start,
                        cell=cell, control=control, group=group)
        code = 0 if line is None else _report(line)
    except Exception:               # the run ends here, with every rank
        traceback.print_exc()
    finally:
        group.abort()               # rank 0: any child still there
        ranks.finish(code)          # not waiting on a process group whose peers are gone
    return code


def _report(line: dict) -> int:
    """Print the numbers compared (last on standard error) and the result's
    line (last on standard output); 3, and no line, where the run loaded a
    module the benchmark may not load."""
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}, which the benchmark may not load", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
