"""kernel: the Triton norm x adaLN x GELU forward's share of its HBM bytes
bound in the traced units (sampling cells)."""
from work import peaks

UNIT = "%"


def read(ctx):
    return peaks.fused_roofline(ctx) if ctx["family"] == "sample" else None
