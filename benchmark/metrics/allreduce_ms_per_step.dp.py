"""gradient exchange: device milliseconds a traced step of the NCCL
all-reduce kernels (the dp step's one all-reduce of its flat gradient
buffer, with the wait for the slowest rank that such a kernel spends on
the card), from rank 0's trace; nothing where no such kernel ran (gloo;
the dp cells)."""
UNIT = "ms"


def read(ctx):
    p, n = ctx["profile"], ctx["counters"].get("steps", 0)
    if ctx["family"] != "dp" or not p or not n:
        return None
    s = sum(v for k, v in p["kernel_s"].items() if "nccl" in k.lower() and "allreduce" in k.lower())
    return 1e3 * s / n if s > 0 else None
