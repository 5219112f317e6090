"""training step: device milliseconds of a step's backward passes (remat's
recomputed forwards included), the ``train.backward`` phase marks of the
step graph's last replay (``aid_tpu_torch.utils.trace.snapshot()``, or
``ctx["trace"]``; nothing from a program without marks; training cells)."""
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
    steps = [g for g in (snap or {}).get("marks", []) if g["graph"] == "train.step"]
    if not steps:
        return None
    backward = [ms for name, ms in max(steps, key=lambda g: g["last"])["marks"]
                if name == "train.backward"]
    return sum(backward) if backward else None
