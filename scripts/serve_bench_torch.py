"""Service-level latency of the PyTorch port's InpaintingService.

Three rows, as the JAX package's ``scripts/serve_bench.py`` measures them:
  * a single-gap request (one 1.5 s centre gap in one model window) at
    ``max_batch=1`` (latency mode);
  * a two-gap request over three windows at the config's ``max_batch``
    (both windows ride one round; skipped when ``max_batch`` is 1);
  * a chained long gap: a 10 s gap in a 30 s clip (sequential passes of the
    chain scheduler).
Each row is one warm-up request, then the best of ``SERVE_REPS`` (3)
timed requests, host clock around ``inpaint`` (which returns host numpy).
Prints one JSON line per row, with the card's name and power limit, and a
markdown table.

Usage: python scripts/serve_bench_torch.py [checkpoint] [override ...] [--device cpu]
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

GAP_S = 1.5                  # the single- and two-gap requests' gaps
CHAIN_AUDIO_S, CHAIN_GAP_S = 30.0, 10.0


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi reports them; a CPU
    run says so."""
    if device.type != "cuda":
        return f"{device.type} (no card)"
    from aid_tpu_torch.tools.profile_denoiser import gpu_line
    return gpu_line()


def _timed(service, audio, mask, fs, seed, reps):
    """Warm-up, then the best of ``reps`` timed requests, in seconds."""
    service.inpaint(audio, mask, fs, seed=1)
    times = []
    for r in range(reps):
        t0 = time.time()
        service.inpaint(audio, mask, fs, seed=seed + 97 * r)
        times.append(time.time() - t0)
    return min(times)


def centre_gap_request(n_samp: int, gap: int, seed: int):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal(n_samp) * 0.063).astype(np.float32)
    mask = np.ones(n_samp, np.float32)
    s = (n_samp - gap) // 2
    mask[s:s + gap] = 0.0
    return audio, mask


def run(checkpoint=None, overrides=(), reps=3, device=None) -> list:
    """The rows (dicts)."""
    from aid_tpu_torch import setup as tsetup
    from aid_tpu_torch.serving import InpaintingService

    dev = tsetup.resolve_device(device)
    card = card_line(dev)
    rows = []

    def row(case, lat, audio_s, gap):
        rows.append({"case": case, "latency_s": lat, "audio_s": audio_s, "gap_s": gap,
                     "rtf": audio_s / lat, "card": card})
        print(json.dumps(rows[-1]), flush=True)

    svc1 = InpaintingService.from_config(overrides, device=dev, checkpoint=checkpoint,
                                         max_batch=1)
    fs = int(svc1.args.exp.sample_rate)
    L = int(svc1.args.exp.audio_len)
    clip_s = L / fs
    audio, mask = centre_gap_request(L, int(GAP_S * fs), 0)
    row("single_gap_latency_b1", _timed(svc1, audio, mask, fs, 2, reps), clip_s, GAP_S)
    del svc1

    svc = InpaintingService.from_config(overrides, device=dev, checkpoint=checkpoint)
    if svc.max_batch > 1:
        # co-batching happens within one inpaint() call: two gaps in three
        # windows ride one round
        n = int(3 * clip_s * fs)
        rng = np.random.default_rng(1)
        audio = (rng.standard_normal(n) * 0.063).astype(np.float32)
        mask = np.ones(n, np.float32)
        g = int(GAP_S * fs)
        for c in (0.25, 0.75):
            s = int(c * n)
            mask[s:s + g] = 0.0
        row(f"two_gap_cobatch_b{svc.max_batch}", _timed(svc, audio, mask, fs, 5, reps),
            n / fs, 2 * GAP_S)

    n = int(CHAIN_AUDIO_S * fs)
    audio, mask = centre_gap_request(n, int(CHAIN_GAP_S * fs), 0)
    row(f"chained_long_gap_b{svc.max_batch}", _timed(svc, audio, mask, fs, 2, reps),
        n / fs, CHAIN_GAP_S)

    print("\n| case | latency s | audio s | gap s | RTF | card |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['case']} | {r['latency_s']:.3f} | {r['audio_s']:.2f} | {r['gap_s']} | "
              f"{r['rtf']:.3f} | {r['card']} |")
    return rows


def main(argv=None) -> int:
    from eval_checkpoints_torch import split_argv
    pos, overrides, device = split_argv(sys.argv[1:] if argv is None else argv)
    run(checkpoint=pos[0] if pos else None, overrides=overrides,
        reps=int(os.environ.get("SERVE_REPS", "3")), device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
