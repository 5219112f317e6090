#!/usr/bin/env python3
"""Two spreads between runs of the port on the card, each traced to its cause.

    python scripts/probe_spread_torch.py bwe
    python scripts/probe_spread_torch.py step [--root DIR] [--reps N] [--gates]

``bwe``: the bandwidth-extension task's answer differs from run to run.
(1) Its firwin lowpass (201 taps, 1 kHz at 22.05 kHz), as the guidance
runs it: y = LPF(x) and the gradient of sum(y * w) by x, at [1, 184184],
f32, twice on the same inputs; (2) the whole task at the 22 kHz flagship's
full width (bf16, T=4, seeded weights, trained-like gates), eager
``heun_sample`` twice on the same noise; (3) its program against the
eager run, and a second program run against the first. Each with TF32
on (PyTorch's cuDNN default), then off, and cuDNN's ``deterministic``
switch off, then on; the maximum absolute (1) or relative (2, 3)
difference.

``step``: the eager flagship training step (22 kHz, full width, batch 4,
f32, remat "block", TF32 off, random weights from a seed (``--gates``:
with the trained-like gates of ``chip_smoke.py``'s trainer), random
native-rate audio) with the remat blocks' ``preserve_rng_state`` forced on and off (in
the order on, off, off, on): for each, one warm-up step, then the wall
time of ``--reps`` steps (host clock, each ending in a synchronise).
``--root`` imports ``aid_tpu_torch`` from another checkout (an older commit
unpacked beside this one), so two commits are timed in one call.

Needs a CUDA device; prints the card's name and power limit first, and one
JSON line per measurement.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def bwe(torch):
    import numpy as np
    from aid_tpu_torch import setup as tsetup
    from aid_tpu_torch.models.unet_cqt import MAIN_SCALE
    from aid_tpu_torch.sampling import degradations as degr
    from aid_tpu_torch.sampling import heun
    from aid_tpu_torch.utils.config import compose
    args = compose(overrides=["tester.T=4"])
    L, fs = int(args.exp.audio_len), float(args.exp.sample_rate)
    net = tsetup.setup_network(args, device="cuda", seed=0)
    net.init_weights(0, gate_scale=MAIN_SCALE)
    s = tsetup.setup_sampler(args, net, tsetup.setup_diff_parameters(args))
    rng = np.random.default_rng(41)
    t = np.arange(L) / fs
    x = sum(np.sin(2 * np.pi * f * t + rng.random() * 6.28) / (k + 1)
            for k, f in enumerate((220.0, 440.0, 1320.0, 2900.0, 5100.0)))
    x = torch.from_numpy((0.2 * x).astype(np.float32))[None].cuda()
    w = torch.from_numpy(rng.standard_normal((1, L)).astype(np.float32)).cuda()
    lpf = degr.bwe_lowpass("firwin", 200, 1000.0, fs)
    gen = torch.Generator(device="cuda").manual_seed(8)
    prior, churn = heun.draw_noise((1, L), s.cfg.T, gen, x.device)
    y = lpf(x)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max() / b.float().abs().max())

    def filt():
        xi = x.clone().requires_grad_(True)
        out = lpf(xi)
        (g,) = torch.autograd.grad((out * w).sum(), xi)
        return out.detach(), g

    def task(programs):
        s.programs_enabled = lambda: programs
        out = s.predict_bwe(y, 1000.0, fs, prior=prior, churn=churn)
        torch.cuda.synchronize()
        return out

    for tf32 in (True, False):
        for det in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
            torch.backends.cudnn.deterministic = det
            (o1, g1), (o2, g2) = filt(), filt()
            e1, e2 = task(False), task(False)
            p1, p2 = task(True), task(True)
            print(json.dumps({"probe": "bwe", "tf32": tf32, "cudnn_deterministic": det,
                              "lowpass_out_max_abs_diff": float((o1 - o2).abs().max()),
                              "lowpass_grad_max_abs_diff": float((g1 - g2).abs().max()),
                              "eager_vs_eager_rel": rel(e2, e1),
                              "program_vs_eager_rel": rel(p1, e1),
                              "replay_vs_replay_rel": rel(p2, p1),
                              "programs": len(s._programs), "card": card()}), flush=True)
    torch.backends.cudnn.deterministic = False


def step(torch, root, reps, gates):
    import numpy as np
    from aid_tpu_torch import setup
    from aid_tpu_torch.models import unet_cqt
    from aid_tpu_torch.train import compose_args
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    md = tempfile.mkdtemp(dir=os.path.join(HERE, "experiments"))
    args = compose_args([f"model_dir={md}", "logging.print_model_summary=False"])
    net = setup.setup_network(args, device="cuda", seed=0, trainable=True)
    if gates:
        from aid_tpu_torch.models.unet_cqt import MAIN_SCALE
        net.init_weights(0, gate_scale=MAIN_SCALE)
    tr = setup.setup_trainer(args, network=net, diff_params=setup.setup_diff_parameters(args))
    tr.init_state()
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((4, int(args.dset.load_len))) * 0.1).astype(np.float32)
    fs = np.array([44100, 48000, 44100, 48000])
    eager = getattr(tr, "_train_step", None)
    run = ((lambda: eager(audio, fs, None, False)) if eager is not None
           else (lambda: tr.train_step(audio, fs)))
    orig, preserve = unet_cqt.checkpoint, [True]

    def checkpoint(*a, **k):
        return orig(*a, **{**k, "preserve_rng_state": preserve[0]})

    unet_cqt.checkpoint = checkpoint
    walls = {"on": [], "off": []}
    for on in (True, False, False, True):
        preserve[0] = on
        run()
        torch.cuda.synchronize()
        for _ in range(reps):
            t0 = time.perf_counter()
            m = run()
            float(m["loss"])
            torch.cuda.synchronize()
            walls["on" if on else "off"].append(time.perf_counter() - t0)
    unet_cqt.checkpoint = orig
    print(json.dumps({"probe": "eager_step", "root": os.path.abspath(root), "gates": gates,
                      "route": "_train_step(program=False)" if eager else "train_step",
                      "preserve_rng_state_s": walls, "card": card()}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=["bwe", "step"])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--gates", action="store_true",
                    help="step: trained-like gates, as chip_smoke.py's trainer has them")
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("probe_spread_torch: no CUDA device")
    print(card(), flush=True)
    os.makedirs(os.path.join(HERE, "experiments"), exist_ok=True)
    if a.what == "bwe":
        bwe(torch)
    else:
        step(torch, os.path.abspath(a.root), a.reps, a.gates)


if __name__ == "__main__":
    main()
