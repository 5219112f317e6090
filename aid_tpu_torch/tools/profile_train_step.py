"""Where one flagship training step's time goes on the card.

    python -m aid_tpu_torch.tools.profile_train_step [--out DIR]

Builds the training configuration as ``python -m aid_tpu_torch.train``
does (the 22 kHz flagship at full width, batch 4, f32, remat "block",
PyTorch's default TF32 convolutions; seeded random weights) and feeds the
trainer host batches of native-rate audio (two rows at 44.1 kHz, two at
48 kHz, ``dset.load_len`` samples). For each route of the step, the
captured step program that ``train_step`` replays (its build timed apart)
and the eager step, reports, each beside the card's name and power limit:

  * the wall time of one training step (host clock around steps that end in
    a synchronise; best of three after two warm-up steps) and the peak
    device memory;
  * one profiled step (``torch.profiler``): the device time (the union of
    its busy intervals), the device's idle share of the profiled window and
    of the unprofiled step's wall time (the profiler slows the host, not the
    device), the longest idle gaps, each named by the innermost ``aid.``
    span (``utils.trace.idle_gaps``: ``aid.train.inputs`` and the like), the
    ten kernels that take the most device time and, for the program, the
    step graph's phase marks (``train.forward``, ``.backward``, ``.update``,
    ms); the full operator table goes to ``DIR/profile_train_step_{route}.txt``.

It needs a CUDA device and fails without one.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from aid_tpu_torch import setup
from aid_tpu_torch.tools.profile_denoiser import gpu_line
from aid_tpu_torch.train import compose_args
from aid_tpu_torch.utils import trace


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="experiments/profile_train_step")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step: no CUDA device")
    os.makedirs(a.out, exist_ok=True)
    gpu = gpu_line()
    args = compose_args([f"model_dir={a.out}/model",
                         "logging.print_model_summary=False"])
    net = setup.setup_network(args, device="cuda", seed=0, trainable=True)
    tr = setup.setup_trainer(args, network=net, diff_params=setup.setup_diff_parameters(args))
    tr.init_state()
    rng = np.random.default_rng(0)
    T = int(args.dset.load_len)
    audio = (rng.standard_normal((4, T)) * 0.1).astype(np.float32)
    fs = np.array([44100, 48000, 44100, 48000])

    t0 = time.perf_counter()
    prog = tr.compile_step(audio, fs)
    torch.cuda.synchronize()
    print(json.dumps({"compile_step_s": time.perf_counter() - t0, "program": prog.report(),
                      "card": gpu}), flush=True)
    # the program first: an eager step moves the state's versions, and the
    # next program step would rebuild
    for route in ("program", "eager"):
        profile_route(a.out, gpu, args, tr, audio, fs, route)


def profile_route(out, gpu, args, tr, audio, fs, route):
    def step():
        tr._train_step(audio, fs, None, program=route == "program")
        torch.cuda.synchronize()

    for _ in range(2):
        step()
    torch.cuda.reset_peak_memory_stats()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        step()
        best = min(best, time.perf_counter() - t0)
    print(json.dumps({"route": route, "train_step_s": best,
                      "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
                      "batch": int(args.exp.batch), "remat": args.network.remat,
                      "tf32_convs": torch.backends.cudnn.allow_tf32, "card": gpu}), flush=True)

    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
    wall = time.perf_counter() - t0
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=60)
    with open(os.path.join(out, f"profile_train_step_{route}.txt"), "w") as f:
        f.write(f"{gpu}\n{table}\n")
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e6
    t = trace.idle_gaps(prof)
    # the profiler slows the host, not the device: the unprofiled idle share
    # is the device's busy time against the unprofiled step's wall time
    line = {"route": route, "profiled_step_wall_s": wall, "device_s": t["busy_ms"] / 1e3,
            "idle_share": t["idle_share"], "idle_share_unprofiled": 1.0 - t["busy_ms"] / 1e3 / best,
            "idle_gaps_ms": t["gaps"], "kernels": len(events), "card": gpu}
    if route == "program":
        (prog,) = tr._step_programs.values()
        line["marks_ms"] = prog.marks.read()
    print(json.dumps(line), flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(json.dumps({"route": route, "kernel": e.key[:90], "calls": e.count,
                          "device_ms": e.self_device_time_total / 1e3,
                          "share": e.self_device_time_total / 1e6 / max(total, 1e-12)}),
              flush=True)


if __name__ == "__main__":
    main()
