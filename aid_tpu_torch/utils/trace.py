"""The port's tracing: host spans on the profiler's clock and device phase
marks inside captured CUDA graphs, kept in one process-wide registry.

Spans. ``with span("serve.request"):`` times a host phase. On the same
boundaries it opens
  * a ``torch.profiler.record_function("aid.<name>")`` range, on kineto's
    clock (the device trace's), only while a profiler runs;
  * an NVTX range ``aid.<name>`` (nsys's clock), where the build has NVTX;
  * a host-clock record (``time.perf_counter_ns``): per name a count, a
    total and the last ``RECENT`` intervals.
No span is opened inside a function that a CUDA graph captures: spans go
around replays.

Marks. ``with mark("heun.denoise"):`` wraps device work inside a function
that a CUDA graph captures. While a ``Marks`` group captures
(``Marks.capturing``, which ``utils.graphs.capture`` takes), a mark records
a pair of timing events (``torch.cuda.Event(enable_timing=True,
external=True)``) around the work; the capture turns each into an
event-record node, so every replay writes it, with no host synchronisation.
Elsewhere (eager steps, the CPU) a mark does nothing. The group's owner
calls ``replayed()`` after each replay; the milliseconds between each pair
are those of the group's last replay, and are read only by ``snapshot()``,
which waits for them.

Counters. ``counter(name, read)`` registers a program counter (a
function returning a number). ``Launches(kernel)`` is the launch count of
one hand-written kernel, forward and backward apart, registered as the
counters ``<kernel>.launches`` and ``<kernel>.bwd_launches``. A launch
that a CUDA graph capture records is not run: it is counted apart,
``utils.graphs.capture`` returns what every kernel's captures recorded
(``captured_launches``), and each replay of the graph adds it
(``replayed_launches``).

``snapshot()`` returns all three as plain numbers, for the benchmark's
readers and for an operator; ``idle_gaps(prof)`` reduces a finished
``torch.profiler`` trace to the device's busy time, its idle share and its
longest idle gaps, each named by the innermost span the host was in.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch

PREFIX = "aid."
RECENT = 4096                   # intervals kept per span name

_LOCK = threading.Lock()
_SEQ = itertools.count()
_GROUPS: "weakref.WeakSet[Marks]" = weakref.WeakSet()
_THREAD = threading.local()     # .capturing: the group whose capture runs in this thread
_COUNTERS: Dict[str, Callable[[], float]] = {}
_LAUNCHES: Dict[str, "Launches"] = {}
_profiler_on = torch._C._autograd._profiler_enabled


class _Stat:
    __slots__ = ("count", "total_ns", "recent")

    def __init__(self):
        self.count, self.total_ns = 0, 0
        self.recent = collections.deque(maxlen=RECENT)


_SPANS: Dict[str, _Stat] = {}


_NVTX = getattr(torch._C, "_nvtx", None)         # absent from builds without CUDA
_push = _NVTX.rangePushA if _NVTX is not None else (lambda name: None)
_pop = _NVTX.rangePop if _NVTX is not None else (lambda: None)


class span:
    """A host phase named ``name`` (see the module's docstring). After it
    closes, ``seconds`` is its length."""
    __slots__ = ("name", "rf", "t0", "t1")

    def __init__(self, name: str):
        self.name, self.rf = name, None

    def __enter__(self) -> "span":
        if _profiler_on():
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        _push(PREFIX + self.name)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter_ns()
        _pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
            self.rf = None
        with _LOCK:
            st = _SPANS.get(self.name)
            if st is None:
                st = _SPANS[self.name] = _Stat()
            st.count += 1
            st.total_ns += self.t1 - self.t0
            st.recent.append((self.t0, self.t1))

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9


class Marks:
    """The phase marks of one program's captured graph(s), named ``graph``
    (e.g. ``heun.body``): the event pairs its captures recorded and its
    replays."""

    def __init__(self, graph: str):
        self.graph = graph
        self.pairs: List[Tuple[str, "torch.cuda.Event", "torch.cuda.Event"]] = []
        self.replays, self.last = 0, -1
        _GROUPS.add(self)

    @contextlib.contextmanager
    def capturing(self):
        """Marks made inside this block, in this thread, are this group's."""
        outer = getattr(_THREAD, "capturing", None)
        _THREAD.capturing = self
        try:
            yield self
        finally:
            _THREAD.capturing = outer

    def replayed(self) -> None:
        self.replays += 1
        self.last = next(_SEQ)

    def read(self) -> List[List]:
        """[[name, ms], ...] of the last replay, in the order the marks
        closed (waits for it)."""
        out = []
        for name, a, b in self.pairs:
            b.synchronize()
            out.append([name, a.elapsed_time(b)])
        return out


@contextlib.contextmanager
def mark(name: str):
    """A device phase inside a captured function (see the module's
    docstring); nothing outside a ``Marks.capturing`` block."""
    group = getattr(_THREAD, "capturing", None)
    if group is None:
        yield
        return
    a = torch.cuda.Event(enable_timing=True, external=True)
    b = torch.cuda.Event(enable_timing=True, external=True)
    a.record()
    yield
    b.record()
    group.pairs.append((name, a, b))


def counter(name: str, read: Callable[[], float]) -> None:
    """Report ``read()`` under ``name`` in every ``snapshot()``."""
    _COUNTERS[name] = read


class Launches:
    """The launches of one hand-written kernel (see the module's docstring):
    ``run`` the (forward, backward) launches run, ``captured`` those that
    captures recorded."""

    def __init__(self, kernel: str):
        self.run = [0, 0]
        self.captured = [0, 0]
        _LAUNCHES[kernel] = self
        counter(f"{kernel}.launches", lambda: self.run[0])
        counter(f"{kernel}.bwd_launches", lambda: self.run[1])

    def launched(self, bwd: bool = False) -> None:
        """One launch of the forward (``bwd``: the backward) kernel."""
        side = self.captured if torch.cuda.is_current_stream_capturing() else self.run
        side[int(bwd)] += 1

    def count(self, bwd: bool = False) -> int:
        """Forward (``bwd``: backward) launches run, replays' included."""
        return self.run[int(bwd)]

    def reset(self) -> None:
        """Zero both run counts."""
        self.run = [0, 0]


def captured_launches(since: Optional[Dict[str, Tuple[int, int]]] = None
                      ) -> Dict[str, Tuple[int, int]]:
    """{kernel: (forward, backward) launches that captures recorded}, so far
    or since the reading ``since``."""
    since = since or {}
    return {k: tuple(n - m for n, m in zip(v.captured, since.get(k, (0, 0))))
            for k, v in _LAUNCHES.items()}


def replayed_launches(recorded: Dict[str, Tuple[int, int]]) -> None:
    """A replay of a graph whose capture recorded ``recorded`` (from
    ``captured_launches``) launched them."""
    for k, (fwd, bwd) in recorded.items():
        run = _LAUNCHES[k].run
        run[0] += fwd
        run[1] += bwd


def snapshot() -> dict:
    """{"spans": {name: {"count", "total_ms", "recent": [[start_ms, end_ms],
    ...]}}, "marks": [{"graph", "replays", "last", "marks": [[name, ms],
    ...]}, ...], "counters": {name: value}}: every span so far (``recent``
    on the host clock, oldest first), the groups of live programs that were
    replayed and hold marks (none on the CPU; ``last`` orders their last
    replays), and each registered counter's value."""
    with _LOCK:
        spans = {k: {"count": s.count, "total_ms": s.total_ns / 1e6,
                     "recent": [[a / 1e6, b / 1e6] for a, b in s.recent]}
                 for k, s in _SPANS.items()}
    groups = sorted((g for g in list(_GROUPS) if g.pairs and g.replays), key=lambda g: g.last)
    return {"spans": spans,
            "marks": [{"graph": g.graph, "replays": g.replays, "last": g.last,
                       "marks": g.read()} for g in groups],
            "counters": {k: read() for k, read in _COUNTERS.items()}}


def reset() -> None:
    """Forget every span recorded so far (marks stay with their programs)."""
    with _LOCK:
        _SPANS.clear()


# ------------------------------------------------------------------ traces

def _union(intervals):
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_gaps(prof, top: int = 10) -> dict:
    """From a finished ``torch.profiler.profile``: the device's busy time
    (the union of its kernels', copies' and sets' intervals, so streams
    that overlap count once), the window (from the first host span or
    device operation to the last), the idle share 1 - busy / window, and
    the ``top`` longest idle gaps, each as [the innermost ``aid.`` span
    the host was in at its start, ms]."""
    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        iv = (e.start_ns(), e.start_ns() + e.duration_ns())
        ours = e.name().startswith(PREFIX)
        if str(e.device_type()).endswith("CUDA"):
            # a span's device-side mirror is a user annotation, not work
            if not (ours or e.is_user_annotation()):
                device.append(iv)
        elif ours:
            spans.append((*iv, e.name()))
    ends = [t for iv in device + [s[:2] for s in spans] for t in iv]
    if not ends:
        return {"busy_ms": 0.0, "window_ms": 0.0, "idle_share": None, "gaps": []}
    lo, hi = min(ends), max(ends)
    busy = _union(device)
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    spans.sort()

    def innermost(at):
        i = bisect.bisect_right(spans, (at, float("inf"), "")) - 1
        while i >= 0:
            if spans[i][0] <= at < spans[i][1]:
                return spans[i][2]
            i -= 1
        return "outside any span"

    busy_ns = sum(b - a for a, b in busy)
    return {"busy_ms": busy_ns / 1e6, "window_ms": (hi - lo) / 1e6,
            "idle_share": 1.0 - busy_ns / (hi - lo) if hi > lo else None,
            "gaps": [[innermost(a), (b - a) / 1e6]
                     for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]]}
