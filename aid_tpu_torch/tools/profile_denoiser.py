"""Where the flagship denoiser's time goes on the card.

    python -m aid_tpu_torch.tools.profile_denoiser [--out DIR]

Builds the served configuration (the 22 kHz flagship, bf16, seeded random
weights) on the GPU and reports, each beside the card's name and power
limit:

  * one denoiser forward and one guided score (forward + input gradient),
    host clock around work that ends in a synchronise;
  * the ten device kernels that take the most time in one guided score
    (``torch.profiler``), written in full to ``DIR/profile_score.txt``.

``gpu_line`` and ``flagship_case`` are shared with ``chip_smoke.py`` and
``scripts/torch_conv_fold.py``. It needs a CUDA device and fails without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.autograd import DeviceType

from aid_tpu_torch import setup
from aid_tpu_torch.diffusion import edm
from aid_tpu_torch.models.unet_cqt import MAIN_SCALE
from aid_tpu_torch.sampling import degradations as degr
from aid_tpu_torch.sampling.heun import make_score_fn
from aid_tpu_torch.utils.config import compose


def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def flagship_case(compute_dtype: str = "bfloat16", batch: int = 1,
                  device="cuda") -> SimpleNamespace:
    """The served configuration at full width with seeded random weights
    (gates at the main layers' scale, as in a trained net) and the inputs of
    one denoiser call and one guided score: ``batch`` rows of noise-like
    audio, each with the 1500 ms centre gap, and sigma from 0.5 (row 0) to
    0.2 (last row). The score takes ``sigma[0]``."""
    args = compose(overrides=[f"network.compute_dtype={compute_dtype}"])
    net = setup.setup_network(args, device=device)
    net.init_weights(0, gate_scale=MAIN_SCALE)
    sampler = setup.setup_sampler(args, net, setup.setup_diff_parameters(args))
    L, fs = int(args.exp.audio_len), int(args.exp.sample_rate)
    rng = np.random.default_rng(0)
    audio = torch.from_numpy(
        (rng.standard_normal((batch, L)) * 0.1).astype(np.float32)).to(device)
    mask = torch.ones(batch, L, device=device)
    gap = int(1.5 * fs)
    mask[:, (L - gap) // 2:(L - gap) // 2 + gap] = 0.0
    y = audio * mask
    score = make_score_fn(sampler.p, sampler.cfg, sampler._denoise, y=y,
                          degradation=degr.time_mask(mask),
                          proj=degr.inpainting_projector(y, mask),
                          hpf=net.cqt.apply_hpf_DC)
    return SimpleNamespace(args=args, net=net, sampler=sampler, audio=audio,
                           mask=mask, sigma=torch.linspace(0.5, 0.2, batch, device=device),
                           score=score)


def wall_s(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_denoiser: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(a.out, exist_ok=True)
    gpu = gpu_line()
    print(json.dumps({"card": gpu, "torch": torch.__version__,
                      "cudnn": torch.backends.cudnn.version()}), flush=True)
    case = flagship_case()
    t = case.sigma[0]

    def fwd():
        with torch.no_grad():
            edm.denoiser(case.sampler.p, case.net, case.audio, case.sigma)

    print(json.dumps({"denoiser_fwd_s": wall_s(fwd),
                      "guided_score_s": wall_s(lambda: case.score(case.audio, t)),
                      "card": gpu}), flush=True)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        case.score(case.audio, t)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    with open(os.path.join(a.out, "profile_score.txt"), "w") as f:
        f.write(f"{gpu}\n{table}\n")
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events)
    print(json.dumps({"guided_score_device_ms": total / 1e3, "kernels": len(events),
                      "card": gpu}), flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(json.dumps({"kernel": e.key[:90], "calls": e.count,
                          "device_ms": e.self_device_time_total / 1e3,
                          "share": e.self_device_time_total / max(total, 1)}), flush=True)


if __name__ == "__main__":
    main()
