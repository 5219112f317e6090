"""The harness on the CPU: its files are found by name and agree with
BENCHMARK.json, the window counts whole units, the trace reduction, and
nothing under benchmark/ loads JAX or the JAX package."""
import ast
import json
import os
import subprocess
import sys

import pytest

import devtrace
import harness

ROOT = os.path.dirname(harness.HERE)


def benchmark_json():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_cell_names_files_that_exist():
    spec = benchmark_json()
    readers = harness.metric_readers()
    configs = {c["name"]: c for c in spec["configs"]}
    for w in spec["workloads"]:
        cell = harness.load_json("workloads", w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert cell["chips"] == w["chips"] == 1
        assert configs[w["config"]]["file"] == f"benchmark/configs/{w['config']}.json"
        mix = harness.load_json("traffic", w["traffic"])
        kind = harness.kind_module(mix["kind"])
        assert kind.TRACE_UNITS >= 1 and kind.FAMILY in ("sample", "train") and hasattr(kind, "Bench")
    for m in spec["per_layer"]:
        assert m["name"] in readers
        assert readers[m["name"]].UNIT == m["unit"]
        assert set(m["workloads"]) <= {w["name"] for w in spec["workloads"]}
    assert set(readers) == {m["name"] for m in spec["per_layer"]}


def test_each_cell_reads_the_per_layer_metrics_listed_for_it():
    """A traced run's readers, given something to read, report in a cell
    exactly the per-layer metrics whose ``workloads`` list it: the kind's
    declared ``FAMILY`` decides, not its name."""
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    readers = harness.metric_readers()
    for w in spec["workloads"]:
        cell = harness.load_json("workloads", w["name"])
        cfg = harness.load_json("configs", cell["config"])
        kind = harness.kind_module(harness.load_json("traffic", cell["traffic"])["kind"])
        ctx = dict(family=kind.FAMILY, cfg=cfg,
                   profile={"busy_s": 9.0, "window_s": 10.0, "kernel_s": {"_fused_adaln_fwd": 1.0}},
                   counters={"scores": 69, "steps": 5, "launches": 900, "trajectories": 1, "rows": 2},
                   built={"capture_s": 7.0, "rows": 2, "itemsize": 2, "guided": True})
        read = {name for name, r in readers.items() if r.read(ctx) is not None}
        assert read == {m["name"] for m in spec["per_layer"] if w["name"] in m["workloads"]}, w["name"]


def test_configuration_files_state_what_the_program_composes():
    import port
    for name in ("cqtdiff_plus_22k", "cqtdiff_plus_44k"):
        cfg = harness.load_json("configs", name)
        # the one departure from the published network: the port's tanh GELU
        assert cfg["reduced"] == ["gelu"] and cfg["network"]["gelu"] == "tanh"
        assert all(k in cfg["assumed"] for k in cfg["reduced"])
        for role in ("serving", "training"):
            port.compose(cfg, role)
        bad = json.loads(json.dumps(cfg))
        bad["network"]["Ns"][0] += 1
        with pytest.raises(ValueError, match="Ns"):
            port.compose(bad, "serving")


@pytest.mark.parametrize("seconds, durations, expect", [
    (30.0, [13.1, 13.1, 13.1], 2),      # a third request would end past 30 s
    (10.0, [13.1, 13.1], 1),            # the first unit always runs
    (30.0, [0.63] * 60, 47),
    (1.0, [0.64] * 5, 1),
])
def test_window_counts_whole_units(seconds, durations, expect):
    w = harness.Window(seconds)
    t = 0.0
    for d in durations:
        if not w.more(t):
            break
        w.add(t, t + d)
        t += d
    assert w.count == expect
    assert w.wall == pytest.approx(sum(durations[:expect]))


def test_window_runs_the_traced_units_past_its_length():
    w = harness.Window(1.0, at_least=3)
    t = 0.0
    while w.more(t):
        w.add(t, t + 5.0)
        t += 5.0
    assert w.count == 3


class Event:
    """A kineto event: its device, name, interval and user-annotation flag."""

    def __init__(self, device, name, start, dur, user=False):
        self.dev, self.n, self.s, self.d, self.u = device, name, start, dur, user

    def device_type(self):
        return f"DeviceType.{self.dev}"

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def is_user_annotation(self):
        return self.u


def test_trace_reduction_unions_and_names_gaps():
    E = Event
    ev = [E("CPU", "bench.unit", 0, 100, True), E("CPU", "bench.inner", 40, 20, True),
          E("CUDA", "a", 0, 30), E("CUDA", "b", 10, 30),           # overlap: busy 0-40
          E("CUDA", "copy", 70, 10),                                # busy 70-80
          E("CUDA", "bench.unit", 0, 100, True),                    # a span's device mirror
          E("CPU", "aten::mm", 5, 90),
          E("CUDA", "a", 90, 20)]                                   # busy 90-100 in the unit
    s = devtrace.reduce(ev)
    assert s["window_s"] == pytest.approx(100e-9)
    assert s["busy_s"] == pytest.approx(60e-9)
    assert s["device_ops"][0] == ["a", pytest.approx(50e-9)]
    assert s["idle_gaps"] == [["bench.inner", pytest.approx(30e-9)], ["bench.unit", pytest.approx(10e-9)]]


FORBIDDEN = set(harness.FORBIDDEN)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def _sources(sub=""):
    top = os.path.join(harness.HERE, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN | {"aid_tpu_torch", "port", "harness"}, \
                (path, name)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "aid_tpu_torch_probe.x", sys)
    assert "aid_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.probe", sys)
    assert "jaxlib" in harness.forbidden_modules()


def test_a_cpu_run_loads_no_jax():
    code = ("import sys, time, json; sys.path[:0] = [%r, %r, %r]\n"
            "import torch; torch.set_num_threads(2)\n"
            "import harness, tiny\n"
            "c = tiny.cell('maestro22k.train_b4')\n"
            "line = harness.run_cell('x', 5, 0.1, True, torch.device('cpu'), time.perf_counter(),"
            " cell=c, cfg=tiny.config(c['config']), mix=tiny.traffic(c['traffic']))\n"
            "print(json.dumps({'found': harness.forbidden_modules(), 'line': line}))\n"
            % (ROOT, harness.HERE, os.path.join(harness.HERE, "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["found"] == []
    assert list(res["line"])[-1] == "checks"
    assert res["line"]["device"]["busy_s"] == 0.0          # no device on the CPU


def test_run_without_a_card_exits_nonzero_and_prints_nothing():
    out = subprocess.run([sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
                          "maestro22k.train_b4", "--seed", str(2 ** 31 + 5), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
