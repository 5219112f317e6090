"""device, whole step: % of the TF32 dense peak that the model FLOPs of the
traced steps are, over their wall (training cells)."""
from work import peaks

UNIT = "%"


def read(ctx):
    if ctx["family"] != "train":
        return None
    from work import counts
    flops = ctx["counters"].get("steps", 0) * counts.step_flops(ctx["cfg"], ctx["built"]["rows"])
    return peaks.mfu(ctx, flops)
