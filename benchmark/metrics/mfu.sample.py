"""device, whole step: % of the bf16 dense peak that the model FLOPs of the
scores in the traced units are, over their wall (sampling cells)."""
from work import peaks

UNIT = "%"


def read(ctx):
    if ctx["family"] != "sample":
        return None
    from work import counts
    b = ctx["built"]
    flops = ctx["counters"].get("scores", 0) * counts.score_flops(ctx["cfg"], b["rows"], b["guided"])
    return peaks.mfu(ctx, flops)
