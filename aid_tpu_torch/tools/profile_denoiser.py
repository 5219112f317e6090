"""Where the flagship denoiser's time goes on the card.

    python -m aid_tpu_torch.tools.profile_denoiser [--out DIR] [--override KEY=VALUE ...]

Builds the served configuration (the 22 kHz flagship, bf16, seeded random
weights; ``--override network=cqtdiff_plus_44k --override exp=musicnet44k_4s``
for the 44.1 kHz one) on the GPU and reports, each beside the card's name
and power limit:

  * one denoiser forward and one guided score (forward + input gradient),
    host clock around work that ends in a synchronise;
  * the ten device kernels that take the most time in one guided score
    (``torch.profiler``), written in full to ``DIR/profile_score.txt``;
  * one step of the guided-Heun body (churn, two guided scores, the Heun
    update) run eagerly and replayed from the sampler's captured program
    (``Sampler.compile_inpainting``): wall time, device time (the union of
    the device's busy intervals under ``torch.profiler``, and the span
    between CUDA events around the step), the device's idle share of the
    profiled window and its longest idle gaps, each named by the innermost
    ``aid.`` span (``utils.trace.idle_gaps``); for the replay also the
    graph's phase marks (``heun.step`` and each ``heun.denoise`` forward, ms).

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
from typing import Sequence

import numpy as np
import torch
from torch.autograd import DeviceType

from aid_tpu_torch import setup
from aid_tpu_torch.diffusion import edm
from aid_tpu_torch.models.unet_cqt import MAIN_SCALE
from aid_tpu_torch.sampling import degradations as degr
from aid_tpu_torch.sampling.heun import draw_noise, make_score_fn
from aid_tpu_torch.utils import trace
from aid_tpu_torch.utils.config import compose


def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def flagship_case(compute_dtype: str = "bfloat16", batch: int = 1,
                  device="cuda", overrides: Sequence[str] = ()) -> SimpleNamespace:
    """The served configuration (``overrides`` select another, e.g. the
    44.1 kHz model) at full width with seeded random weights (gates at the
    main layers' scale, as in a trained net) and the inputs of one denoiser
    call and one guided score: ``batch`` rows of noise-like audio, each with
    the 1500 ms centre gap, and sigma from 0.5 (row 0) to 0.2 (last row).
    The score takes ``sigma[0]``."""
    args = compose(overrides=[*overrides, f"network.compute_dtype={compute_dtype}"])
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


def traced(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (CUPTI), reduced by
    ``utils.trace.idle_gaps``: busy and window ms, idle share, longest gaps."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return trace.idle_gaps(prof, top=5)


def event_ms(fn, reps: int = 3) -> float:
    """The shortest span, between CUDA events on the current stream, of
    one call of ``fn``."""
    best = float("inf")
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def body_step(case) -> dict:
    """One guided-Heun body step of ``case`` at its first step's values,
    eagerly (``heun_body`` over the program's buffers) and replayed from
    the captured graph: wall, device time and idle share of each."""
    prog = case.sampler.compile_inpainting(case.audio * case.mask, case.mask)
    prog.bufs["y"].copy_(case.audio * case.mask)
    prog.bufs["mask"].copy_(case.mask)
    prog.bufs["smooth"].copy_(case.mask)
    gen = torch.Generator(device=case.audio.device).manual_seed(0)
    prior, churn = draw_noise(prog.shape, prog.cfg.T, gen, case.audio.device)
    start = prior * prog.t[0]

    def eager():
        with trace.span("heun.body"):
            prog.x.copy_(start)
            prog._set_step(0, churn)
            prog._body()

    def replay():
        with trace.span("heun.body"):
            prog.x.copy_(start)
            prog._set_step(0, churn)
            prog.graphs["body"].replay()
            prog.marks["body"].replayed()

    out = {"capture_s": prog.capture_s, "warm_up_s": prog.warm_up_s,
           "memory_bytes": prog.memory_bytes(), "launches_per_replay": prog.replay_launches()["body"]}
    for name, fn in (("eager", eager), ("graph", replay)):
        wall = wall_s(fn)
        t = traced(fn)
        out[name] = {"wall_ms": wall * 1e3, "device_ms": t["busy_ms"], "event_ms": event_ms(fn),
                     "idle_share": t["idle_share"], "idle_gaps_ms": t["gaps"]}
    out["graph"]["marks_ms"] = prog.marks["body"].read()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--override", action="append", default=[],
                    help="a config override, e.g. network=cqtdiff_plus_44k (repeatable)")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_denoiser: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(a.out, exist_ok=True)
    gpu = gpu_line()
    print(json.dumps({"card": gpu, "torch": torch.__version__,
                      "cudnn": torch.backends.cudnn.version()}), flush=True)
    case = flagship_case(overrides=a.override)
    print(json.dumps({"overrides": a.override, "sample_rate": int(case.args.exp.sample_rate),
                      "audio_len": int(case.args.exp.audio_len)}), flush=True)
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
    print(json.dumps({"guided_score_device_ms": trace.idle_gaps(prof)["busy_ms"],
                      "kernels": len(events), "card": gpu}), flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(json.dumps({"kernel": e.key[:90], "calls": e.count,
                          "device_ms": e.self_device_time_total / 1e3,
                          "share": e.self_device_time_total / max(total, 1)}), flush=True)
    print(json.dumps({"heun_body_step": body_step(case), "card": gpu}), flush=True)


if __name__ == "__main__":
    main()
