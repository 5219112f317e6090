"""The PyTorch port's (5, 3) convs on the card: folded against cuDNN's dilated form.

    python scripts/torch_conv_fold.py

``Conv2dFT`` in ``aid_tpu_torch/models/unet_cqt.py`` runs a frequency
dilation d as an undilated conv on d phases folded into the batch. For every
distinct (5, 3) conv of one flagship denoiser forward (bf16, batch 1) this
prints, beside the card's name and power limit: the folded conv's forward
and forward + input gradient, and for d > 1 cuDNN's own dilated conv on the
same channels-last input; then the sums over one forward. CUDA-event times,
the mean of 5 calls after 2 warm-ups. It needs a CUDA device.
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch
import torch.nn.functional as F


def event_ms(fn, reps=5):
    for _ in range(2):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def conv_table(net, audio, cn):
    """(F, T, C_in, C_out, dilation) -> count of every (5, 3) conv of one
    forward, read with forward pre-hooks."""
    from aid_tpu_torch.models.unet_cqt import Conv2dFT
    seen = {}

    def hook(m, args):
        x = args[0]
        key = (x.shape[1], x.shape[2], x.shape[3], m.weight.shape[0], m.dilation[0])
        seen[key] = seen.get(key, 0) + 1

    hs = [m.register_forward_pre_hook(hook) for m in net.modules()
          if isinstance(m, Conv2dFT) and m.kernel != (1, 1)]
    with torch.no_grad():
        net(audio, cn)
    for h in hs:
        h.remove()
    return seen


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_conv_fold: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from aid_tpu_torch.diffusion import edm
    from aid_tpu_torch.models.unet_cqt import Conv2dFT
    from aid_tpu_torch.tools.profile_denoiser import flagship_case, gpu_line

    gpu = gpu_line()
    case = flagship_case()
    table = conv_table(case.net, case.audio, edm.cnoise(case.sampler.p, case.sigma[:, None]))
    dt = case.net.dtype
    del case
    rows = []
    for (Fd, T, Ci, Co, d), n in sorted(table.items()):
        conv = Conv2dFT(Ci, Co, (5, 3), dilation=(d, 1)).to("cuda", dt)
        with torch.no_grad():
            conv.weight.normal_(0.0, 0.05)
        x = torch.randn(1, Fd, T, Ci, device="cuda", dtype=dt)
        g = torch.randn(1, Fd, T, Co, device="cuda", dtype=dt)
        with torch.no_grad():
            fwd = event_ms(lambda: conv(x))
            dilated = (event_ms(lambda: F.conv2d(x.permute(0, 3, 1, 2), conv.weight,
                                                 padding=(2 * d, 1), dilation=(d, 1)))
                       if d > 1 else None)
        xg = x.detach().requires_grad_(True)
        row = dict(F=Fd, T=T, C_in=Ci, C_out=Co, dilation=d, count=n, fwd_ms=fwd,
                   fwd_dgrad_ms=event_ms(lambda: torch.autograd.grad(conv(xg), xg, g)),
                   dilated_cudnn_fwd_ms=dilated)
        rows.append(row)
        print(json.dumps({"conv": row, "card": gpu}), flush=True)
    print(json.dumps({
        "convs_per_forward": sum(r["count"] for r in rows),
        "conv_fwd_ms_per_forward": sum(r["count"] * r["fwd_ms"] for r in rows),
        "conv_fwd_dgrad_ms_per_forward": sum(r["count"] * r["fwd_dgrad_ms"] for r in rows),
        "dilated_cudnn_fwd_ms_per_forward": sum(
            r["count"] * (r["dilated_cudnn_fwd_ms"] or r["fwd_ms"]) for r in rows),
        "card": gpu}), flush=True)


if __name__ == "__main__":
    main()
