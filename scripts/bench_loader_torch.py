"""Host-side data-loader throughput of the PyTorch port (the twin of
``scripts/bench_loader.py``).

Measures batches/s of the MAESTRO train pipeline (native WAV segment decode
-> batched() -> prefetch) for several worker counts, against a training
step's budget: by default the port's replayed flagship step at batch 4,
631 ms on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, "Where the time
goes"), so the loader must sustain >= 6.3 segments/s per card to stay off
the critical path; data parallelism multiplies that by the rank count.

The corpus is synthetic but realistically sized (MAESTRO files are minutes
long; the loader reads random ~18 s native-rate windows by random-access
decode), so the measured cost per segment -- open + seek + decode + copy --
matches the real corpus shape. ``--flac`` writes a LibriSpeech-shaped FLAC
corpus instead (``tests/flac_fixture.py``, numpy only).

Usage:  python scripts/bench_loader_torch.py [--files N] [--secs S] [--batches K]
Host only: it needs no device.
"""
import argparse
import csv
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

STEP_MS = 631.0     # the replayed flagship step, batch 4, f32 (H100 80GB HBM3, 700 W)


def _signal(j: int, secs: float, fs: int, rng) -> np.ndarray:
    t = np.arange(int(secs * fs)) / fs
    f0 = 110.0 * (1 + j % 8)
    return (0.2 * np.sin(2 * np.pi * f0 * t)
            + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


def make_corpus(root: str, n_files: int, secs: float, fs: int = 44100):
    """MAESTRO v3 layout: ``2015/file_<j>.wav`` and the CSV listing them."""
    from aid_tpu_torch.data import audio_io
    rows = []
    rng = np.random.default_rng(0)
    for j in range(n_files):
        rel = f"2015/file_{j}.wav"
        os.makedirs(os.path.join(root, "2015"), exist_ok=True)
        audio_io.write(os.path.join(root, rel), _signal(j, secs, fs, rng), fs)
        rows.append({"year": 2015, "split": "train", "audio_filename": rel})
    with open(os.path.join(root, "maestro-v3.0.0.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["year", "split", "audio_filename"])
        w.writeheader()
        w.writerows(rows)


def make_flac_corpus(root: str, n_files: int, secs: float, fs: int = 16000):
    """LibriSpeech-shaped corpus: per-speaker dirs of .flac utterances
    (decode cost is the realistic part: LPC FLAC at the corpus rate)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests"))
    import flac_fixture
    rng = np.random.default_rng(0)
    for j in range(n_files):
        d = os.path.join(root, f"{100 + j}", "1")
        os.makedirs(d, exist_ok=True)
        flac_fixture.encode(os.path.join(d, f"{100 + j}-1-{j:04d}.flac"),
                            [_signal(j, secs, fs, rng)], fs)


def bench(args, callable_name, batch_size, num_workers, n_batches):
    """Batches a second after one warm-up batch (the workers' start and
    first decode)."""
    from aid_tpu_torch.data.loader import MultiProcessLoader, make_train_loader
    from aid_tpu_torch.utils.registry import call_func_by_name
    if num_workers > 0:
        it = MultiProcessLoader(args, callable_name, batch_size, num_workers)
    else:
        ds = call_func_by_name(args, func_name=callable_name)
        it = make_train_loader(iter(ds), batch_size)
    try:
        next(it)
        t0 = time.perf_counter()
        for _ in range(n_batches):
            next(it)
        dt = time.perf_counter() - t0
    finally:
        if num_workers > 0:
            it.close()
    return n_batches / dt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--files", type=int, default=12)
    ap.add_argument("--secs", type=float, default=120.0)
    ap.add_argument("--batches", type=int, default=40)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--step-ms", type=float, default=STEP_MS,
                    help="train-step budget to compare against (default: the port's "
                         "replayed flagship step at batch 4, f32, on an NVIDIA H100 80GB "
                         "HBM3 at 700 W)")
    ap.add_argument("--flac", action="store_true",
                    help="LibriSpeech-shaped FLAC corpus (native LPC decode) "
                         "instead of MAESTRO WAV")
    opts = ap.parse_args(argv)

    from aid_tpu_torch.utils.config import compose
    with tempfile.TemporaryDirectory() as root:
        kind = "flac" if opts.flac else "wav"
        corpus = os.path.join(root, "corpus")
        print(f"generating {kind} corpus: {opts.files} files x {opts.secs:.0f}s ...")
        if opts.flac:
            make_flac_corpus(corpus, opts.files, opts.secs)
            overrides = ["dset=librispeech", f"dset.path={corpus}"]
        else:
            make_corpus(corpus, opts.files, opts.secs)
            overrides = ["dset=maestro_allyears", f"dset.path={corpus}",
                         "dset.load_len=800000"]  # ~18 s native window, the reference's
        args = compose(overrides=overrides + [
            "logging.print_model_summary=False", f"model_dir={os.path.join(root, 'md')}",
        ])
        callable_name = args.dset.callable
        need = opts.batch_size / (opts.step_ms / 1e3)
        print(f"train step budget {opts.step_ms:.0f} ms @ batch "
              f"{opts.batch_size} => need {need:.1f} segments/s\n")
        for nw in (0, 2, 4):
            bps = bench(args, callable_name, opts.batch_size, nw, opts.batches)
            sps = bps * opts.batch_size
            ok = "OK" if sps >= need else "BOTTLENECK"
            print(f"num_workers={nw}:  {bps:6.2f} batches/s  "
                  f"{sps:7.1f} segments/s  {sps / need:6.1f}x budget  [{ok}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
