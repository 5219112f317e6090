"""End-to-end learning gate of the PyTorch port: train a tiny CQTDiff+ on
synthetic chords, then inpaint a gap with the trained EMA weights and hold
the result to the JAX package's pinned quality gates.

Proves that the whole loop (data -> training step with the fused kernel in
every forward -> EMA -> checkpoint -> guided sampler with data consistency)
learns, without a dataset or a released checkpoint: the gap SNR after
training must beat the untrained network's on the same task by at least
``SMOKE_MIN_SNR_GAIN_DB``, and the in-gap log-spectral distance must fall to
at most ``SMOKE_MAX_LSD_RATIO`` of the untrained network's. The tiny
network, the chord generator, the 50 ms centre gap and the thresholds are
those of the JAX package's ``scripts/e2e_smoke.py``.

Run on the card (the default) or the CPU:
    python scripts/e2e_smoke_torch.py [--device cpu]
Environment knobs (defaults): SMOKE_L (16384), SMOKE_ITS (400), SMOKE_DTYPE
(bfloat16: the sampling compute dtype; training runs in f32),
SMOKE_MIN_SNR_GAIN_DB (4.0), SMOKE_MAX_LSD_RATIO (0.95), SMOKE_GELU (the
network's gelu), SMOKE_GELU_SWEEP and SMOKE_QUANT_SWEEP (sample the trained
weights under every gelu flavour / through int8). Prints ``E2E SMOKE PASS``
and exits 0, or ``E2E SMOKE FAIL`` and exits 1.
"""
import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

FS = 22050
BATCH = 8
SAMPLE_SEED = 5
NOTES = np.asarray([220.0, 261.6, 329.6, 392.0, 440.0])


def config_from_env(env=None) -> dict:
    """The run's settings from the ``SMOKE_*`` environment knobs."""
    env = os.environ if env is None else env
    return {"L": int(env.get("SMOKE_L", "16384")),
            "its": int(env.get("SMOKE_ITS", "400")),
            "dtype": env.get("SMOKE_DTYPE", "bfloat16"),
            "min_gain_db": float(env.get("SMOKE_MIN_SNR_GAIN_DB", "4.0")),
            "max_lsd_ratio": float(env.get("SMOKE_MAX_LSD_RATIO", "0.95")),
            "gelu": env.get("SMOKE_GELU") or None,
            "gelu_sweep": bool(env.get("SMOKE_GELU_SWEEP")),
            "quant_sweep": bool(env.get("SMOKE_QUANT_SWEEP")),
            "model_dir": os.path.join(tempfile.gettempdir(), "aid_tpu_torch_smoke")}


def overrides(cfg: dict, compute_dtype: str) -> list:
    """The tiny network and training settings of the JAX smoke."""
    return [
        "exp=test_cqtdiff_22k",
        f"exp.audio_len={cfg['L']}",
        f"exp.batch={BATCH}",
        f"exp.total_its={cfg['its']}",
        "exp.lr=3e-4",
        "exp.lr_rampup_it=50",
        "exp.ema_rampup=50",
        "network.cqt.num_octs=5",
        "network.cqt.bins_per_oct=16",
        "network.Ns=[16,24,24,32,32]",
        "network.num_dils=[1,2,2,3,3]",
        "network.attention_layers=[0,0,0,1,1,1]",
        f"network.compute_dtype={compute_dtype}",
        "tester.T=25",
        "tester.order=2",
        "tester.posterior_sampling.xi=0.25",
        "logging.save_model=False",
        "logging.log_interval=100",
        "logging.print_model_summary=False",
        "diff_params.sigma_data=0.2",
        "tester.diff_params.sigma_data=0.2",
        f"model_dir={cfg['model_dir']}",
    ] + ([f"network.gelu={cfg['gelu']}"] if cfg.get("gelu") else [])


def make_batch(rng, n: int, L: int) -> np.ndarray:
    """Random 3-note chords from a pentatonic set under a shared envelope
    (highly structured, learnable by a tiny network). The envelope's floor
    keeps every region audible: an SNR in a near-silent gap means nothing."""
    t = np.arange(L) / FS
    x = np.zeros((n, L), np.float32)
    for i in range(n):
        f0 = rng.choice(NOTES, size=3, replace=False)
        ph = rng.uniform(0, 2 * np.pi, 3)
        env = 0.7 + 0.3 * np.sin(2 * np.pi * rng.uniform(0.3, 1.0) * t
                                 + rng.uniform(0, 6.28))
        x[i] = env * sum(0.12 * np.sin(2 * np.pi * f * t + p) for f, p in zip(f0, ph))
    return x.astype(np.float32)


class SynthSet:
    """Infinite training batches (audio [8, L], fs [8]) from a seeded rng."""

    def __init__(self, L: int):
        self.L = L
        self.rng = np.random.default_rng(0)

    def __iter__(self):
        return self

    def __next__(self):
        return make_batch(self.rng, BATCH, self.L), np.full((BATCH,), FS, np.int64)


def centre_gap(L: int):
    """The 50 ms centre gap: (mask [1, L], gap slice)."""
    gap = int(0.05 * FS)
    s = (L - gap) // 2
    mask = np.ones((1, L), np.float32)
    mask[:, s:s + gap] = 0.0
    return mask, slice(s, s + gap)


def gap_snr(clean: np.ndarray, rec: np.ndarray, g: slice) -> float:
    err = rec[0, g] - clean[0, g]
    return float(10 * np.log10(np.sum(clean[0, g] ** 2) / (np.sum(err ** 2) + 1e-12)))


def gate(gain_db: float, lsd_ratio: float, min_gain_db: float, max_lsd_ratio: float) -> bool:
    """Pass when training lifted the gap SNR by at least ``min_gain_db`` and
    cut the gap LSD to at most ``max_lsd_ratio`` of the untrained net's."""
    return gain_db >= min_gain_db and lsd_ratio <= max_lsd_ratio


def sample(args, ediff, state_dict, y_masked: np.ndarray, mask: np.ndarray, device) -> np.ndarray:
    """Guided inpainting (``setup_sampler(...).predict_inpainting``) with a
    serving network of ``args`` holding ``state_dict``, noise from a
    generator seeded with ``SAMPLE_SEED``; returns host f32 [1, L]."""
    from aid_tpu_torch import setup as tsetup
    net = tsetup.setup_network(args, device=device, state_dict=state_dict)
    sampler = tsetup.setup_sampler(args, network=net, diff_params=ediff)
    gen = torch.Generator(device=device).manual_seed(SAMPLE_SEED)
    with torch.no_grad():
        rec = sampler.predict_inpainting(torch.from_numpy(y_masked).to(device),
                                         torch.from_numpy(mask).to(device), generator=gen)
    return rec.detach().float().cpu().numpy()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg: dict, device=None) -> dict:
    """Train, sample before and after, score; returns the numbers, the
    verdict (``ok``) and what a caller needs to sample the trained weights
    again (``args``, ``ediff``, ``ema``, ``y_masked``, ``mask``, ``rec``)."""
    from aid_tpu_torch import setup as tsetup
    from aid_tpu_torch.ops import fused_adaln as fa
    from aid_tpu_torch.testing import metrics as qm
    from aid_tpu_torch.utils import logging_utils as logu
    from aid_tpu_torch.utils.config import compose

    dev = tsetup.resolve_device(device)
    L = cfg["L"]
    # training stays in f32 (the port's training default); sampling runs in
    # the smoke's compute dtype
    args_train = compose(overrides=overrides(cfg, "float32"))
    args = compose(overrides=overrides(cfg, cfg["dtype"]))
    ediff = tsetup.setup_diff_parameters(args)
    net = tsetup.setup_network(args_train, device=dev, seed=0, trainable=True)

    # the untrained network on the same task: the fair difficulty reference
    clean = make_batch(np.random.default_rng(99), 1, L)
    mask, g = centre_gap(L)
    y_masked = clean * mask
    init = {k: v.detach().clone() for k, v in net.state_dict().items()}

    def timed_sample(sd):
        _sync(dev)
        n0, t0 = fa.launch_count(), time.time()
        rec = sample(args, ediff, sd, y_masked, mask, dev)
        _sync(dev)
        return rec, time.time() - t0, fa.launch_count() - n0

    rec0, sample0_s, sample_launches = timed_sample(init)
    snr_untrained = gap_snr(clean, rec0, g)
    print(f"gap SNR untrained: {snr_untrained:.2f} dB", flush=True)

    trainer = tsetup.setup_trainer(args_train, dset=SynthSet(L), network=net, diff_params=ediff)
    trainer.init_state()
    _sync(dev)
    n0, t0 = fa.launch_count(), time.time()
    final_it = trainer.training_loop()
    _sync(dev)
    train_s, train_launches = time.time() - t0, fa.launch_count() - n0
    print(f"trained {final_it} its in {train_s:.1f}s", flush=True)
    os.makedirs(cfg["model_dir"], exist_ok=True)
    ckpt_path = trainer.save_checkpoint()      # network and EMA, for offline study
    ema = {k: v.detach().clone() for k, v in zip(trainer.names, trainer.ema)}
    del trainer, net

    rec, sample_s, _ = timed_sample(ema)
    snr = gap_snr(clean, rec, g)
    print(f"gap SNR after training: {snr:.2f} dB (untrained {snr_untrained:.2f})", flush=True)
    for name, sig in (("clean", clean), ("masked", y_masked), ("reconstructed", rec)):
        logu.write_audio_file(sig[0], FS, name, cfg["model_dir"])

    sweeps = {}
    if cfg.get("gelu_sweep"):
        trained_with = str(args.network.gelu)
        for v in ("erf", "tanh", "sigmoid"):
            if v == trained_with:
                print(f"gap SNR gelu={v}: {snr:.2f} dB (trained with)", flush=True)
                continue
            rv = sample(compose(overrides=overrides(cfg, cfg["dtype"]) + [f"network.gelu={v}"]),
                        ediff, ema, y_masked, mask, dev)
            sweeps[f"gelu={v}"] = gap_snr(clean, rv, g)
            print(f"gap SNR gelu={v}: {sweeps[f'gelu={v}']:.2f} dB  "
                  f"(max|delta| vs {trained_with} = {np.max(np.abs(rv - rec)):.2e})", flush=True)
    if cfg.get("quant_sweep"):
        rq = sample(compose(overrides=overrides(cfg, cfg["dtype"]) + ["network.quant=int8"]),
                    ediff, ema, y_masked, mask, dev)
        sweeps["quant=int8"] = gap_snr(clean, rq, g)
        print(f"gap SNR quant=int8: {sweeps['quant=int8']:.2f} dB vs none {snr:.2f}  "
              f"(max|delta| = {np.max(np.abs(rq - rec)):.2e})", flush=True)

    # the gates score the gap region, trained against untrained
    lsd_gap_tr = qm.lsd(clean[0, g], rec[0, g], n_fft=256, hop=64)
    lsd_gap_un = qm.lsd(clean[0, g], rec0[0, g], n_fft=256, hop=64)
    lsd_rec = qm.lsd(clean[0], rec[0], n_fft=512, hop=128)
    lsd_masked = qm.lsd(clean[0], y_masked[0], n_fft=512, hop=128)
    print(f"gap LSD trained {lsd_gap_tr:.3f} vs untrained {lsd_gap_un:.3f}; full-signal LSD "
          f"reconstructed {lsd_rec:.3f} vs masked {lsd_masked:.3f}", flush=True)
    gain = snr - snr_untrained
    ratio = lsd_gap_tr / max(lsd_gap_un, 1e-9)
    ok = gate(gain, ratio, cfg["min_gain_db"], cfg["max_lsd_ratio"])
    print(f"gates: snr gain {gain:.2f} dB (min {cfg['min_gain_db']}), gap-LSD ratio "
          f"{ratio:.3f} (max {cfg['max_lsd_ratio']})", flush=True)
    return {"ok": ok, "device": str(dev), "its": final_it, "L": L, "dtype": cfg["dtype"],
            "snr_untrained_db": snr_untrained, "snr_trained_db": snr, "snr_gain_db": gain,
            "lsd_gap_trained": lsd_gap_tr, "lsd_gap_untrained": lsd_gap_un,
            "lsd_gap_ratio": ratio, "lsd_full_reconstructed": lsd_rec,
            "lsd_full_masked": lsd_masked, "sweeps": sweeps,
            "train_s": train_s, "s_per_it": train_s / max(final_it, 1),
            "sample_untrained_s": sample0_s, "sample_trained_s": sample_s,
            "launches_per_train_step": train_launches / max(final_it, 1),
            "launches_per_sampling_run": sample_launches, "checkpoint": ckpt_path,
            "args": args, "ediff": ediff, "ema": ema, "y_masked": y_masked, "mask": mask,
            "rec": rec}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: CUDA)")
    cli = ap.parse_args(argv)
    res = run(config_from_env(), device=cli.device)
    print("E2E SMOKE", "PASS" if res["ok"] else "FAIL", flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
