"""training step: host milliseconds a step before its graphs run, the median
over the run's steps of the time from the program's span ``train.step``'s
start to the start of its ``train.replay``; a step that built its program
(a ``program.build`` inside it) is left out
(``aid_tpu_torch.utils.trace.snapshot()``, or ``ctx["trace"]``; nothing
from a program without spans; training cells)."""
import bisect
import statistics

UNIT = "ms"


def _snapshot(ctx):
    if "trace" in ctx:
        return ctx["trace"]
    try:
        from aid_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.snapshot()


def read(ctx):
    snap = _snapshot(ctx) if ctx["family"] == "train" else None
    spans = (snap or {}).get("spans", {})
    replays = sorted(a for a, _ in spans.get("train.replay", {}).get("recent", []))
    builds = spans.get("program.build", {}).get("recent", [])
    host = []
    for a, b in spans.get("train.step", {}).get("recent", []):
        i = bisect.bisect_left(replays, a)
        if i == len(replays) or replays[i] > b or any(a <= c and d <= b for c, d in builds):
            continue
        host.append(replays[i] - a)
    return statistics.median(host) if host else None
