"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit), and the shares of them the per-layer
metrics report."""
from __future__ import annotations

from typing import Optional

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {2: 989e12,     # bf16 tensor cores: the serving configurations
              4: 495e12}     # TF32 tensor cores: float32 training with TF32 convs


def describe() -> str:
    return (f"{PEAK_FLOPS[2] / 1e12:.0f} TFLOP/s bf16, {PEAK_FLOPS[4] / 1e12:.0f} TFLOP/s TF32, "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s (H100 SXM data sheet, at 700 W)")


def fused_roofline(ctx: dict, pattern: str = "_fused_adaln_fwd") -> Optional[float]:
    """% of the HBM bound the fused norm x adaLN x GELU kernel reached in the
    traced units: the bytes its launches need (launches counted by the
    program, bytes from the shapes by ``counts.fused_bytes``) at 3.35 TB/s,
    over the summed time of the kernels whose name holds ``pattern``; None
    where the architecture has no fused launches."""
    from work import counts
    p, c, b = ctx["profile"], ctx["counters"], ctx["built"]
    launches = counts.fused_launches(ctx["cfg"])
    if not p or not c.get("launches") or not launches:
        return None
    kernel_s = sum(s for name, s in p["kernel_s"].items() if pattern in name)
    if kernel_s <= 0:
        return None
    forwards = c["launches"] / len(launches)
    need = forwards * counts.fused_bytes(ctx["cfg"], b["rows"], b["itemsize"])
    return 100.0 * need / HBM_BYTES_PER_S / kernel_s


def idle_pct(ctx: dict) -> Optional[float]:
    """% of the traced window in which no kernel, copy or set ran."""
    p = ctx["profile"]
    if not p or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def mfu(ctx: dict, flops: float) -> Optional[float]:
    """% of the compute dtype's dense peak that ``flops`` in the traced window is."""
    p = ctx["profile"]
    if not p or p["busy_s"] <= 0 or flops <= 0:
        return None
    return 100.0 * flops / p["window_s"] / PEAK_FLOPS[ctx["built"]["itemsize"]]
