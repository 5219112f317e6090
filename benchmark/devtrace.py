"""A torch.profiler trace of whole units, reduced in memory: the union of
the device's busy intervals, its idle gaps named by the harness span the
host was in, and the device operations that took the most time.

Device time is the union of the intervals of kernels, copies and sets
(streams that overlap count once). The traced window runs from the first
traced unit's start to the last one's end, as the harness span ``bench.unit``
marks them on the profiler's clock. Nothing is written to disk.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merged, sorted intervals."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def gaps(busy: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The idle intervals of [lo, hi) around the merged ``busy`` ones."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def innermost(spans: List[Tuple[int, int, str]], t: int) -> str:
    """Name of the latest-starting span that contains t (spans sorted by start)."""
    i = bisect.bisect_right(spans, (t, float("inf"), "")) - 1
    while i >= 0:
        a, b, name = spans[i]
        if a <= t < b:
            return name
        i -= 1
    return "outside any span"


def classify(e) -> Optional[str]:
    """"device" for a kernel, copy or set: an event on a CUDA device that is
    not a user annotation (the device-side mirror of a span); "span" for a
    harness span on the host; None for the rest."""
    user = e.is_user_annotation() if hasattr(e, "is_user_annotation") else False
    ours = e.name().startswith("bench.")
    if str(e.device_type()).endswith("CUDA"):
        return None if user or ours else "device"
    return "span" if ours else None


def _interval(e) -> Tuple[int, int]:
    return e.start_ns(), e.start_ns() + e.duration_ns()


def reduce(events, top: int = 10) -> Optional[dict]:
    """busy_s, window_s, the ``top`` device operations by summed seconds and
    the ``top`` longest idle gaps by span, from kineto events; None when
    no unit span was traced."""
    device, spans, units = [], [], []
    for e in events:
        kind = classify(e)
        if kind == "device":
            device.append((*_interval(e), e.name()))
        elif kind == "span":
            s = (*_interval(e), e.name())
            spans.append(s)
            if e.name() == "bench.unit":
                units.append(s)
    if not units:
        return None
    lo, hi = min(u[0] for u in units), max(u[1] for u in units)
    busy = union(clip([(a, b) for a, b, _ in device], lo, hi))
    busy_ns = sum(b - a for a, b in busy)
    by_name: Dict[str, int] = {}
    for a, b, name in device:
        by_name[name] = by_name.get(name, 0) + (b - a)
    spans.sort()
    idle = sorted(gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:top]
    return {"busy_s": busy_ns / 1e9, "window_s": (hi - lo) / 1e9, "device_events": len(device),
            "kernel_s": {k: v / 1e9 for k, v in by_name.items()},
            "device_ops": [[k, v / 1e9] for k, v in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[innermost(spans, a), (b - a) / 1e9] for a, b in idle]}


class Profile:
    """start() / stop() around whole units; summary() reduces the trace once."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.running = False
        self._summary = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.running = True

    def stop(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        self.running = False

    def summary(self) -> Optional[dict]:
        if self._summary is None and self.prof is not None:
            self._summary = reduce(self.prof.profiler.kineto_results.events())
        return self._summary
