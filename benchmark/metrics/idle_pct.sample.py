"""device: % of the traced units' wall in which the device ran nothing
(sampling cells)."""
from work import peaks

UNIT = "%"


def read(ctx):
    return peaks.idle_pct(ctx) if ctx["family"] == "sample" else None
