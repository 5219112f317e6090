"""serving: host milliseconds a request, the median over the run's requests
of the program's span ``serve.request`` less the ``serve.device`` spans of
its rounds (``aid_tpu_torch.utils.trace.snapshot()``, or ``ctx["trace"]``;
nothing from a program without spans; sampling cells)."""
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
    snap = _snapshot(ctx) if ctx["family"] == "sample" else None
    spans = (snap or {}).get("spans", {})
    requests = spans.get("serve.request", {}).get("recent", [])
    device = spans.get("serve.device", {}).get("recent", [])
    if not requests:
        return None
    return statistics.median((b - a) - sum(d1 - d0 for d0, d1 in device if a <= d0 and d1 <= b)
                             for a, b in requests)
