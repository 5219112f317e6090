"""The port's tracing (``aid_tpu_torch.utils.trace``) on the CPU: spans and
their registry, marks as no-ops off a capture, the spans of a served
request and of training steps, the idle-gap reduction of the profiling
tools, and the benchmark's readers of the snapshot."""
import importlib.util
import os
import time

import numpy as np
import pytest
import torch

from aid_tpu_torch import setup as tsetup
from aid_tpu_torch.serving import InpaintingService
from aid_tpu_torch.utils import trace
from aid_tpu_torch.utils.config import compose
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _within(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_a_span_records_count_and_duration_and_nests():
    trace.reset()
    with trace.span("test.outer") as outer:
        for _ in range(2):
            with trace.span("test.inner"):
                time.sleep(0.002)
    spans = trace.snapshot()["spans"]
    assert spans["test.outer"]["count"] == 1 and spans["test.inner"]["count"] == 2
    (o,), inner = spans["test.outer"]["recent"], spans["test.inner"]["recent"]
    assert all(_within(i, o) for i in inner) and inner[0][1] <= inner[1][0]
    assert all(b - a >= 2.0 for a, b in inner)
    assert spans["test.inner"]["total_ms"] == pytest.approx(sum(b - a for a, b in inner))
    assert outer.seconds * 1e3 == pytest.approx(o[1] - o[0])
    trace.reset()
    assert trace.snapshot()["spans"] == {}


def test_a_span_opens_a_profiler_range_only_under_a_profiler(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *a):
        opened.append(name)
        return real(name, *a)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with trace.span("test.quiet"):
        pass
    assert opened == []
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("test.loud"):
            torch.ones(4).sum()
    assert opened == ["aid.test.loud"]
    assert "aid.test.loud" in {e.name for e in prof.events()}


def test_the_registry_keeps_the_last_intervals(monkeypatch):
    monkeypatch.setattr(trace, "RECENT", 3)
    trace.reset()
    for _ in range(5):
        with trace.span("test.ring"):
            pass
    s = trace.snapshot()["spans"]["test.ring"]
    assert s["count"] == 5 and len(s["recent"]) == 3
    trace.reset()


def test_marks_off_a_capture_do_nothing_and_are_not_read():
    group = trace.Marks("test.graph")
    with trace.mark("test.phase"):
        torch.ones(3).sum()
    group.replayed()
    assert group.pairs == []
    assert all(g["graph"] != "test.graph" for g in trace.snapshot()["marks"])


@pytest.mark.parametrize("bwd", [False, True])
def test_a_kernels_launches_in_a_capture_count_when_replayed(bwd, monkeypatch):
    """``trace.Launches``: a launch outside a capture is run; one inside is
    recorded apart, read since a reading by ``captured_launches``, and run
    by each replay (``replayed_launches``); the counters report the runs."""
    monkeypatch.setattr(trace, "_LAUNCHES", {})
    monkeypatch.setattr(trace, "_COUNTERS", {})
    k, other = trace.Launches("test_kernel"), trace.Launches("test_other")
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    k.launched(bwd)
    before = trace.captured_launches()
    capturing[0] = True
    k.launched(bwd)
    k.launched(bwd)
    recorded = trace.captured_launches(since=before)
    side = (0, 2) if bwd else (2, 0)
    assert recorded == {"test_kernel": side, "test_other": (0, 0)}
    assert k.count(bwd) == 1
    trace.replayed_launches(recorded)
    trace.replayed_launches(recorded)
    assert (k.count(), k.count(bwd=True)) == ((0, 5) if bwd else (5, 0))
    counters = trace.snapshot()["counters"]
    assert counters[f"test_kernel.{'bwd_' if bwd else ''}launches"] == 5
    assert other.count() == other.count(bwd=True) == 0
    k.reset()
    assert counters != trace.snapshot()["counters"] and k.count(bwd) == 0


TINY_SERVE = ["network.cqt.num_octs=3", "network.cqt.bins_per_oct=8", "exp.audio_len=2048",
              "exp.sample_rate=4096", "network.Ns=[8,16,16]", "network.num_dils=[1,2,2]",
              "network.attention_layers=[0,1,1,1]", "network.emb_dim=32",
              "network.attention_dict.num_heads=2", "network.compute_dtype=float32",
              "tester.T=3"]


def test_inpaint_records_a_request_and_three_spans_a_round():
    svc = InpaintingService.from_config(TINY_SERVE, device="cpu", max_batch=1)
    audio = (np.random.default_rng(0).standard_normal(6000) * 0.1).astype(np.float32)
    mask = np.ones(6000, np.float32)
    mask[500:560] = mask[4000:4100] = 0.0        # two windows, one row a round
    trace.reset()
    out = svc.inpaint(audio, mask, 4096, seed=1)
    assert np.isfinite(out).all()
    snap = trace.snapshot()
    spans = snap["spans"]
    (request,) = spans["serve.request"]["recent"]
    rounds = [spans[f"serve.{k}"]["recent"] for k in ("prepare", "device", "finish")]
    assert [len(r) for r in rounds] == [2, 2, 2]
    order = [iv for rnd in zip(*rounds) for iv in rnd]    # prepare, device, finish, prepare, ...
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))
    assert all(_within(iv, request) for iv in order)
    # the program's spans inside each round's device span: T - 1 body steps, a last
    T = svc.sampler.cfg.T
    assert spans["heun.run"]["count"] == spans["sample.noise"]["count"] == 2
    assert spans["heun.body"]["count"] == 2 * (T - 1) and spans["heun.last"]["count"] == 2
    for run in spans["heun.run"]["recent"]:
        assert any(_within(run, dev) for dev in rounds[1])
    assert spans["program.build"]["count"] == 1                 # one row count, built once
    assert snap["marks"] == []                                  # no marks on the CPU
    host = _reader("host_ms_per_request.sample").read(dict(family="sample", trace=snap))
    busy = sum(b - a for a, b in rounds[1])
    assert host == pytest.approx(request[1] - request[0] - busy)


TINY_TRAIN = ["exp.audio_len=2048", "exp.batch=2", "exp.total_its=3", "exp.lr_rampup_it=2",
              "exp.mesh.dp=1", "network.cqt.num_octs=3", "network.cqt.bins_per_oct=8",
              "network.Ns=[8,16,16]", "network.num_dils=[1,1,1]",
              "network.attention_layers=[0,0,1,1]", "network.compute_dtype=float32",
              "network.remat=False", "logging.print_model_summary=False"]


def test_train_step_records_its_phases_and_keeps_the_build_apart(tmp_path):
    args = compose(overrides=TINY_TRAIN + [f"model_dir={tmp_path}"])
    net = tsetup.setup_network(args, device="cpu", seed=1, trainable=True)
    tr = tsetup.setup_trainer(args, network=net, diff_params=tsetup.setup_diff_parameters(args))
    tr.init_state()
    audio = (np.random.default_rng(0).standard_normal((2, 2048)) * 0.1).astype(np.float32)
    fs = np.array([int(args.exp.sample_rate)] * 2)
    trace.reset()
    for _ in range(3):
        tr.train_step(audio, fs)
    snap = trace.snapshot()
    spans = snap["spans"]
    steps = spans["train.step"]["recent"]
    assert len(steps) == 3
    for name in ("train.inputs", "train.program", "train.run", "train.replay"):
        assert spans[name]["count"] == 3
        assert all(_within(iv, s) for iv, s in zip(spans[name]["recent"], steps)), name
    for s, (i, p, r) in zip(steps, zip(*(spans[f"train.{k}"]["recent"]
                                           for k in ("inputs", "program", "run")))):
        assert i[1] <= p[0] and p[1] <= r[0]
    (build,) = spans["program.build"]["recent"]                  # the first step builds
    assert _within(build, spans["train.program"]["recent"][0])
    assert tr._step_programs and all(
        p.report()["warm_up_s"] == p.report()["graph_capture_s"] == 0.0
        for p in tr._step_programs.values())
    host = _reader("host_ms_per_step.train").read(dict(family="train", trace=snap))
    later = [r[0] - s[0] for s, r in zip(steps, spans["train.replay"]["recent"])][1:]
    assert host == pytest.approx(float(np.median(later)))
    assert snap["marks"] == []


class _Event:
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


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def test_idle_gaps_unions_busy_intervals_and_names_gaps_by_span():
    E = _Event
    prof = _Prof([E("CPU", "aid.train.step", 0, 100, True), E("CPU", "aid.train.inputs", 40, 20, True),
                  E("CUDA", "a", 0, 30), E("CUDA", "b", 10, 30),      # overlap: busy 0-40
                  E("CUDA", "copy", 70, 10),                          # busy 70-80
                  E("CUDA", "aid.train.step", 0, 100, True),          # a span's device mirror
                  E("CPU", "aten::mm", 5, 90),
                  E("CUDA", "a", 90, 30)])                            # busy 90-120
    t = trace.idle_gaps(prof)
    assert t["window_ms"] == pytest.approx(120e-6) and t["busy_ms"] == pytest.approx(80e-6)
    assert t["idle_share"] == pytest.approx(1 - 80 / 120)
    assert t["gaps"] == [["aid.train.inputs", pytest.approx(30e-6)],
                         ["aid.train.step", pytest.approx(10e-6)]]
    assert trace.idle_gaps(_Prof([]))["idle_share"] is None


def _reader(name):
    path = os.path.join(ROOT, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("trace_reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SNAP = {"spans": {"serve.request": {"count": 2, "total_ms": 26040.0,
                                    "recent": [[0.0, 13010.0], [13100.0, 26130.0]]},
                  "serve.device": {"count": 3, "total_ms": 25970.0,
                                   "recent": [[4.0, 12994.0], [13110.0, 19610.0],
                                              [19615.0, 26125.0]]},
                  "train.step": {"count": 3, "total_ms": 23900.0,
                                 "recent": [[0.0, 22000.0], [22000.0, 22630.0],
                                            [22630.0, 23260.0]]},
                  "train.replay": {"count": 3, "total_ms": 3.0,
                                   "recent": [[21000.0, 21001.0], [22006.0, 22007.0],
                                              [22638.0, 22639.0]]},
                  "program.build": {"count": 1, "total_ms": 20000.0,
                                    "recent": [[10.0, 20010.0]]}},
        "marks": [{"graph": "heun.body", "replays": 34, "last": 3,
                   "marks": [["heun.denoise", 41.0], ["heun.denoise", 43.0], ["heun.step", 382.0]]},
                  {"graph": "heun.body", "replays": 34, "last": 1,
                   "marks": [["heun.denoise", 1.0], ["heun.step", 2.0]]},
                  {"graph": "heun.last", "replays": 1, "last": 4,
                   "marks": [["heun.denoise", 41.0], ["heun.step", 190.0]]},
                  {"graph": "train.step", "replays": 5, "last": 2,
                   "marks": [["train.forward", 150.0], ["train.backward", 400.0],
                             ["train.update", 70.0]]}]}


@pytest.mark.parametrize("name, family, value", [
    ("host_ms_per_request.sample", "sample", 20.0),      # median of 20 and 20
    ("guidance_ms_per_score.sample", "sample", 149.0),   # (382 - 84) / 2, the latest body
    ("host_ms_per_step.train", "train", 7.0),            # median of 6 and 8; the build left out
    ("backward_ms_per_step.train", "train", 400.0),
])
def test_each_reader_reads_its_family_and_nothing_else(name, family, value):
    reader = _reader(name)
    assert reader.UNIT == "ms"
    assert reader.read(dict(family=family, trace=SNAP)) == pytest.approx(value)
    other = "train" if family == "sample" else "sample"
    assert reader.read(dict(family=other, trace=SNAP)) is None
    assert reader.read(dict(family=family, trace={"spans": {}, "marks": []})) is None
