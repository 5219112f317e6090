"""Checkpoint-over-checkpoint guided-inpainting evaluation on the PyTorch
port.

For every checkpoint of a training run (the port's ``{exp_name}-{it}.pt``
and the JAX package's stream ``{exp_name}-{it}.ckpt``, in iteration order)
it loads the EMA weights and runs the flagship's guided long-gap inpainting
(the configured tester: T=35, order 2, xi=0.25; a 1.5 s centre gap) on
held-out clips from the corpus's 2009 split, reporting the gap SNR and gap
LSD per clip and a set-level FAD (the port's log-mel embedder,
reconstructed against clean full signals) per checkpoint, beside the
masked input's own numbers (the floor any checkpoint must beat). The table
goes to ``{model_dir}/eval_ledger.json`` in the JAX script's layout.

Usage:
  python scripts/eval_checkpoints_torch.py <model_dir> <corpus_root> [n_clips] \
      [override ...] [--device cpu]
Env: EVAL_BATCH (4 clips a sampler call), EVAL_ITS (e.g. "2,4": only these
iterations), EVAL_SEED (1234: the sampler's noise), EVAL_WAV_DIR (write
original / masked / reconstructed wavs of two clips per checkpoint here).
"""
import glob
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

WORKLOAD = "guided inpainting T={T} order-{order} xi={xi}, 1.5 s center gap"


def split_argv(argv):
    """(positional arguments, overrides, device) of a script's argv."""
    argv = list(argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            raise SystemExit("--device needs a value (cpu, cuda, cuda:1, ...)")
        device = argv[i + 1]
        del argv[i:i + 2]
    pos = [a for a in argv if "=" not in a]
    return pos, [a for a in argv if "=" in a], device


def load_clip(path: str, offset_s: float, L: int, fs: int, device) -> Optional[np.ndarray]:
    """[1, L] at ``fs`` from ``offset_s`` into a file: 2L + 256 samples at
    the file's rate, resampled on ``device`` as the training and test paths
    do, then cropped; None when the file is too short."""
    from aid_tpu_torch.data import audio_io
    from aid_tpu_torch.training.utils import resample_batch
    x, ffs = audio_io.read(path)
    off = int(offset_s * ffs)
    seg = x[off:off + 2 * L + 256]
    if seg.shape[-1] < 2 * L + 256:
        return None
    y = resample_batch(torch.from_numpy(np.ascontiguousarray(seg[None], np.float32)).to(device),
                       [int(ffs)], fs)
    return y[:, :L].float().cpu().numpy()


def held_out_files(corpus: str) -> list:
    files = sorted(glob.glob(os.path.join(corpus, "2009", "*.wav")))
    if not files:
        raise FileNotFoundError(f"no 2009/ test split under {corpus}")
    return files


def checkpoint_it(path: str) -> int:
    return int(os.path.basename(path).rsplit("-", 1)[1].split(".")[0])


def run(model_dir: str, corpus: str, n_clips: int = 16, overrides=(), device=None,
        env=None) -> dict:
    """Evaluate every checkpoint of ``model_dir``; returns the ledger."""
    from aid_tpu_torch import setup as tsetup
    from aid_tpu_torch.data import audio_io
    from aid_tpu_torch.testing import metrics
    from aid_tpu_torch.testing.tester import Tester
    from aid_tpu_torch.utils import checkpoint as ckpt
    from aid_tpu_torch.utils.config import compose

    env = os.environ if env is None else env
    dev = tsetup.resolve_device(device)
    args = compose(overrides=["exp=maestro22k_8s", "logging.print_model_summary=False",
                              f"model_dir={model_dir}", *overrides])
    L, fs = int(args.exp.audio_len), int(args.exp.sample_rate)

    # held-out clips: several non-overlapping offsets per file, so a small
    # test split still yields n_clips
    files = held_out_files(corpus)
    per_file = max(1, -(-n_clips // len(files)))
    clips = []
    for f in files:
        for j in range(per_file):
            if len(clips) >= n_clips:
                break
            c = load_clip(f, 10.0 + 30.0 * j, L, fs, dev)
            if c is not None:
                clips.append(c)
    if not clips:
        raise ValueError(f"no test file under {corpus} is long enough for one clip")
    clean = np.concatenate(clips, axis=0)
    print(f"eval set: {clean.shape[0]} clips x {L / fs:.2f} s from {len(files)} held-out files",
          flush=True)

    gap = int(1.5 * fs)
    s = (L - gap) // 2
    mask = np.ones_like(clean)
    mask[:, s:s + gap] = 0.0
    masked = clean * mask
    g = slice(s, s + gap)

    eval_bs = int(env.get("EVAL_BATCH", "4"))
    seed = int(env.get("EVAL_SEED", "1234"))
    net = tsetup.setup_network(args, device=dev, seed=0)
    tester = Tester(args, network=net, diff_params=tsetup.setup_diff_parameters(args),
                    device=dev)

    def run_all() -> np.ndarray:
        """Guided inpainting over the set in chunks of eval_bs clips; chunk
        i's noise from a generator seeded with EVAL_SEED + i."""
        outs = []
        for i in range(0, clean.shape[0], eval_bs):
            gen = torch.Generator(device=dev).manual_seed(seed + i)
            with torch.no_grad():
                rec = tester.sampler.predict_inpainting(
                    torch.from_numpy(masked[i:i + eval_bs]).to(dev),
                    torch.from_numpy(mask[i:i + eval_bs]).to(dev), generator=gen)
            outs.append(rec.float().cpu().numpy())
        return np.concatenate(outs, axis=0)

    ckpts = ckpt.list_checkpoints(model_dir, str(args.exp.exp_name))
    only = env.get("EVAL_ITS", "")
    if only:
        keep = {int(v) for v in only.split(",") if v}
        ckpts = [c for c in ckpts if checkpoint_it(c) in keep]
    if not ckpts:
        raise FileNotFoundError(f"no checkpoints of {args.exp.exp_name} under {model_dir}")
    wav_dir = env.get("EVAL_WAV_DIR", "")

    def embed(x):
        return np.concatenate([metrics.logmel_embedder(x[i], fs) for i in range(len(x))])

    clean_emb = embed(clean)
    n = clean.shape[0]
    base = {"gap_snr_db": float(np.mean([metrics.snr(clean[i, g], masked[i, g])
                                         for i in range(n)])),
            "gap_lsd": float(np.mean([metrics.lsd(clean[i, g], masked[i, g])
                                      for i in range(n)])),
            "fad_logmel": float(metrics.fad_from_embeddings(embed(masked), clean_emb))}
    print(f"{'it':>8} {'gap SNR dB':>11} {'gap LSD':>9} {'FAD':>8}  per-clip SNR")
    print(f"{'masked':>8} {base['gap_snr_db']:>11.2f} {base['gap_lsd']:>9.3f} "
          f"{base['fad_logmel']:>8.3f}  (degraded-input floor)", flush=True)

    rows = []
    for path in ckpts:
        it = checkpoint_it(path)
        tester.load_checkpoint(path)              # the EMA weights
        rec = run_all()
        snrs = [float(metrics.snr(clean[i, g], rec[i, g])) for i in range(n)]
        lsds = [float(metrics.lsd(clean[i, g], rec[i, g])) for i in range(n)]
        fad = float(metrics.fad_from_embeddings(embed(rec), clean_emb))
        rows.append((it, float(np.mean(snrs)), float(np.mean(lsds)), fad))
        print(f"{it:>8} {np.mean(snrs):>11.2f} {np.mean(lsds):>9.3f} {fad:>8.3f}  "
              + " ".join(f"{v:.2f}" for v in snrs), flush=True)
        if wav_dir:
            os.makedirs(wav_dir, exist_ok=True)
            for i in range(min(2, n)):
                audio_io.write(os.path.join(wav_dir, f"it{it}_clip{i}_rec.wav"), rec[i], fs)
                if path == ckpts[0]:
                    audio_io.write(os.path.join(wav_dir, f"clip{i}_orig.wav"), clean[i], fs)
                    audio_io.write(os.path.join(wav_dir, f"clip{i}_masked.wav"), masked[i], fs)

    print("\n| it | gap SNR (dB) | gap LSD | FAD (logmel) |")
    print("|---|---|---|---|")
    for it, sn, ls, fd in rows:
        print(f"| {it} | {sn:.2f} | {ls:.3f} | {fd:.3f} |")
    t = args.tester
    ledger = {"workload": WORKLOAD.format(T=t.T, order=t.order, xi=t.posterior_sampling.xi),
              "n_clips": n, "masked_baseline": base,
              "columns": ["it", "gap_snr_db", "gap_lsd", "fad_logmel"], "rows": rows}
    path = os.path.join(model_dir, "eval_ledger.json")
    with open(path, "w") as f:
        json.dump(ledger, f, indent=1)
    print(f"ledger -> {path}", flush=True)
    return ledger


def main(argv=None) -> int:
    pos, overrides, device = split_argv(sys.argv[1:] if argv is None else argv)
    run(pos[0], pos[1], int(pos[2]) if len(pos) > 2 else 16, overrides, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
