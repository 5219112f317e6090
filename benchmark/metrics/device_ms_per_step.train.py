"""training step: device time (the union of busy intervals) of the traced
steps, per step (training cells)."""
UNIT = "ms"


def read(ctx):
    p, n = ctx["profile"], ctx["counters"].get("steps", 0)
    if ctx["family"] != "train" or not p or p["busy_s"] <= 0 or not n:
        return None
    return 1e3 * p["busy_s"] / n
