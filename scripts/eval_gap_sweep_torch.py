"""Gap-length sweep on one checkpoint with the PyTorch port (the MUSHRA
grid of the reference's tester: 371, 743, 1486 and 2962 ms gaps,
centre-placed).

Guided long-gap inpainting (the configured tester) on held-out 2009-split
clips, one clip per file at 10 s, reporting the gap SNR and gap LSD per
length; a length that leaves less than 2048 samples of context is skipped.
The table goes to ``gap_sweep.json`` beside the checkpoint.

Usage:
  python scripts/eval_gap_sweep_torch.py <checkpoint (.pt or .ckpt)> <corpus_root> \
      [n_clips] [override ...] [--device cpu]
Env: EVAL_WAV_DIR (write the reconstructions of two clips per gap length here).
"""
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from eval_checkpoints_torch import held_out_files, load_clip, split_argv  # noqa: E402

GAPS_MS = (371, 743, 1486, 2962)
NOISE_SEED = 1234


def run(checkpoint: str, corpus: str, n_clips: int = 4, overrides=(), device=None,
        env=None) -> dict:
    """Sweep the gap lengths on ``checkpoint``'s EMA weights; returns the
    table."""
    from aid_tpu_torch import setup as tsetup
    from aid_tpu_torch.data import audio_io
    from aid_tpu_torch.testing import metrics
    from aid_tpu_torch.testing.tester import Tester
    from aid_tpu_torch.utils.config import compose

    env = os.environ if env is None else env
    dev = tsetup.resolve_device(device)
    out_dir = os.path.dirname(os.path.abspath(checkpoint))
    args = compose(overrides=["exp=maestro22k_8s", "logging.print_model_summary=False",
                              f"model_dir={out_dir}", *overrides])
    L, fs = int(args.exp.audio_len), int(args.exp.sample_rate)
    clips = [load_clip(f, 10.0, L, fs, dev) for f in held_out_files(corpus)[:n_clips]]
    if any(c is None for c in clips):
        raise ValueError(f"a test file under {corpus} is shorter than 10 s + 2L + 256 samples")
    clean = np.concatenate(clips, axis=0)

    net = tsetup.setup_network(args, device=dev, seed=0)
    tester = Tester(args, network=net, diff_params=tsetup.setup_diff_parameters(args),
                    device=dev)
    if not tester.load_checkpoint(checkpoint):       # the EMA weights
        raise FileNotFoundError(checkpoint)

    wav_dir = env.get("EVAL_WAV_DIR", "")
    print(f"{'gap ms':>8} {'gap SNR dB':>11} {'gap LSD':>9}  per-clip SNR")
    rows = []
    for gms in GAPS_MS:
        gap = int(gms / 1000.0 * fs)
        if gap >= L - 2048:  # the gap must leave context on both sides
            print(f"{gms:>8}  (skipped: gap {gap} >= window {L} - 2048)", flush=True)
            continue
        s = (L - gap) // 2
        mask = np.ones_like(clean)
        mask[:, s:s + gap] = 0.0
        gen = torch.Generator(device=dev).manual_seed(NOISE_SEED)
        with torch.no_grad():
            rec = tester.sampler.predict_inpainting(
                torch.from_numpy(clean * mask).to(dev), torch.from_numpy(mask).to(dev),
                generator=gen).float().cpu().numpy()
        g = slice(s, s + gap)
        snrs = [float(metrics.snr(clean[i, g], rec[i, g])) for i in range(clean.shape[0])]
        lsds = [float(metrics.lsd(clean[i, g], rec[i, g])) for i in range(clean.shape[0])]
        rows.append((gms, float(np.mean(snrs)), float(np.mean(lsds))))
        print(f"{gms:>8} {np.mean(snrs):>11.2f} {np.mean(lsds):>9.3f}  "
              + " ".join(f"{v:.2f}" for v in snrs), flush=True)
        if wav_dir:
            os.makedirs(wav_dir, exist_ok=True)
            for i in range(min(2, clean.shape[0])):
                audio_io.write(os.path.join(wav_dir, f"gap{gms}ms_clip{i}_rec.wav"), rec[i], fs)

    print("\n| gap (ms) | gap SNR (dB) | gap LSD |")
    print("|---|---|---|")
    for gms, sn, ls in rows:
        print(f"| {gms} | {sn:.2f} | {ls:.3f} |")
    t = args.tester
    table = {"workload": f"guided inpainting T={t.T} order-{t.order} "
                         f"xi={t.posterior_sampling.xi}, MUSHRA gap grid (center-placed)",
             "checkpoint": os.path.abspath(checkpoint), "n_clips": int(clean.shape[0]),
             "columns": ["gap_ms", "gap_snr_db", "gap_lsd"], "rows": rows}
    path = os.path.join(out_dir, "gap_sweep.json")
    with open(path, "w") as f:
        json.dump(table, f, indent=1)
    print(f"ledger -> {path}", flush=True)
    return table


def main(argv=None) -> int:
    pos, overrides, device = split_argv(sys.argv[1:] if argv is None else argv)
    run(pos[0], pos[1], int(pos[2]) if len(pos) > 2 else 4, overrides, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
