"""guided score: device milliseconds of the guidance a score (the norm, its
backward and the Heun update with the projection), from the phase marks of
the body graph's last replay: (``heun.step`` less its ``heun.denoise``
forwards) over its forwards (``aid_tpu_torch.utils.trace.snapshot()``, or
``ctx["trace"]``; nothing from a program without marks; sampling cells)."""
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
    body = [g for g in (snap or {}).get("marks", []) if g["graph"] == "heun.body"]
    if not body:
        return None
    marks = max(body, key=lambda g: g["last"])["marks"]
    forwards = [ms for name, ms in marks if name == "heun.denoise"]
    step = sum(ms for name, ms in marks if name == "heun.step")
    if not forwards or step <= 0:
        return None
    return (step - sum(forwards)) / len(forwards)
