"""Flagship training-step timing of the PyTorch port on one CUDA card (the
twin of ``scripts/bench_train.py``).

Composes the flagship config (remat on), feeds synthetic batches and
times the trainer's step (resample -> sigma draw -> loss -> gradients ->
clip -> Adam -> EMA -> stats), which replays the step program that the
first step captures. The host clock goes around the steps and ends in a
synchronise. Prints the first step's seconds (its warm-up and capture
included), the card's name and power limit, then the ms per step.

Usage:  python scripts/bench_train_torch.py [override ...] [--device cpu]
Env:    TRAIN_BENCH_STEPS (default 10)
"""
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def main(argv=None) -> int:
    import torch

    from aid_tpu_torch import setup as tsetup
    from aid_tpu_torch.utils.config import compose
    from eval_checkpoints_torch import split_argv
    from serve_bench_torch import card_line

    _, overrides, device = split_argv(sys.argv[1:] if argv is None else argv)
    args = compose(overrides=["network.remat=True",
                              "logging.print_model_summary=False",
                              "logging.save_model=False",
                              f"model_dir={os.path.join(tempfile.gettempdir(), 'aid_bench_train')}"]
                   + overrides)
    B = int(args.exp.batch)
    L = int(args.exp.audio_len)
    fs = int(args.exp.sample_rate)

    rng = np.random.default_rng(0)

    def batch():
        return (rng.standard_normal((B, L)).astype(np.float32) * 0.05,
                np.full((B,), fs, np.int64))

    dev = tsetup.resolve_device(device)
    net = tsetup.setup_network(args, device=dev, seed=int(args.exp.get("seed", 42)),
                               trainable=True)
    trainer = tsetup.setup_trainer(args, dset=iter(batch, None), network=net,
                                   diff_params=tsetup.setup_diff_parameters(args))
    trainer.init_state()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.time()
    trainer.train_step(*batch())
    sync()
    print(f"first step (capture): {time.time() - t0:.1f}s", flush=True)

    steps = int(os.environ.get("TRAIN_BENCH_STEPS", "10"))
    t0 = time.time()
    for _ in range(steps):
        trainer.train_step(*batch())
    sync()
    dt = (time.time() - t0) / steps
    audio_s = B * L / fs
    print(f"gpu: {card_line(dev)}")
    print(f"train step: {dt * 1e3:.1f} ms  (global batch {B}, "
          f"{audio_s:.2f} s audio/step -> {audio_s / dt:.1f}x realtime)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
