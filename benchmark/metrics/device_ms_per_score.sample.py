"""guided score, denoiser: device time (the union of busy intervals) in the
traced units over the denoiser calls they ran (sampling cells)."""
UNIT = "ms"


def read(ctx):
    p, n = ctx["profile"], ctx["counters"].get("scores", 0)
    if ctx["family"] != "sample" or not p or p["busy_s"] <= 0 or not n:
        return None
    return 1e3 * p["busy_s"] / n
