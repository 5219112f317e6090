"""serving: windows a round of ``InpaintingService.inpaint`` in the traced
units, the rows of the sampler's programs over the trajectories their
replays ran (sampling cells)."""
UNIT = "rows"


def read(ctx):
    c = ctx["counters"]
    if ctx["family"] != "sample" or not c.get("trajectories"):
        return None
    return c["rows"] / c["trajectories"]
