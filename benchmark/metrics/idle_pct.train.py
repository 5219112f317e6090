"""device: % of the traced steps' wall in which the device ran nothing
(training cells)."""
from work import peaks

UNIT = "%"


def read(ctx):
    return peaks.idle_pct(ctx) if ctx["family"] == "train" else None
