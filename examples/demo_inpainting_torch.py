"""End-to-end inpainting demo on the PyTorch port (the reference's notebook
flow: checkpoint -> compose the config -> mask -> sample -> listen).

Usage:
    python examples/demo_inpainting_torch.py --wav input.wav \
        --checkpoint maestro_22k_8s-750000.pt --gap-ms 1500 --out out/

``--checkpoint`` takes a released reference ``.pt``, one of the port's
training checkpoints or a JAX stream ``.ckpt`` directory (EMA weights, as
``Tester.load_checkpoint`` reads them). Without ``--wav`` it inpaints a
synthetic tone cluster, so the pipeline runs anywhere; ``--spectrogram``
masks the tester's time-frequency box instead of a time gap. Runs on CUDA
unless ``--device cpu``. Writes original / degraded / reconstructed wavs
and a spectrogram ``.png`` beside each into ``--out``.
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

NOISE_SEED = 42


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wav", default=None, help="input audio (wav or flac)")
    ap.add_argument("--checkpoint", default=None, help=".pt file or .ckpt directory")
    ap.add_argument("--gap-ms", type=float, default=1500.0)
    ap.add_argument("--xi", type=float, default=0.35,
                    help="guidance strength (the notebook's default)")
    ap.add_argument("--T", type=int, default=35)
    ap.add_argument("--out", default="demo_out")
    ap.add_argument("--spectrogram", action="store_true",
                    help="mask a time-frequency box instead of a time gap")
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: CUDA)")
    return ap.parse_args(argv)


def run(cli: argparse.Namespace, overrides=()) -> dict:
    """The demo for parsed arguments ``cli``; ``overrides`` are appended to
    the composed config. Returns the written paths and the three signals."""
    from aid_tpu_torch import setup as tsetup
    from aid_tpu_torch.data import audio_io
    from aid_tpu_torch.sampling import degradations as degr
    from aid_tpu_torch.testing.tester import Tester
    from aid_tpu_torch.utils import logging_utils as logu
    from aid_tpu_torch.utils.config import compose

    dev = tsetup.resolve_device(cli.device)
    args = compose(overrides=[f"tester.T={cli.T}", f"tester.posterior_sampling.xi={cli.xi}",
                              f"model_dir={cli.out}", "tester.modes=['inpainting']",
                              *overrides])
    fs = int(args.exp.sample_rate)
    L = int(args.exp.audio_len)
    net = tsetup.setup_network(args, device=dev, seed=0)
    ediff = tsetup.setup_diff_parameters(args)
    tester = Tester(args, network=net, diff_params=ediff, device=dev)
    if cli.checkpoint:
        if not tester.load_checkpoint(cli.checkpoint):
            raise FileNotFoundError(cli.checkpoint)
    else:
        print("NOTE: no checkpoint given - sampling with random weights", flush=True)

    if cli.wav:
        x, in_fs = audio_io.read(cli.wav)
        x = audio_io.resample_host(x, in_fs, fs)
    else:
        tgrid = np.arange(L) / fs
        x = sum(0.1 * np.sin(2 * np.pi * f0 * tgrid)
                for f0 in (220.0, 277.2, 329.6)).astype(np.float32)
    if x.shape[-1] < L:
        x = np.pad(x, (0, L - x.shape[-1]))
    x = np.asarray(x[:L], np.float32)[None]

    os.makedirs(cli.out, exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(NOISE_SEED)
    xt = torch.from_numpy(x).to(dev)
    with torch.no_grad():
        if cli.spectrogram:
            mask_FT = torch.from_numpy(tester.prepare_spectral_mask()).to(dev)
            apply_mask = degr.spectral_mask(mask_FT, args.tester.spectrogram_inpainting.stft)
            y_masked = apply_mask(xt)
            rec = tester.sampler.predict_spectrogram_inpainting(y_masked, mask_FT, gen)
        else:
            gap = int(cli.gap_ms / 1000 * fs)
            mask = np.ones((1, L), np.float32)
            s = (L - gap) // 2
            mask[:, s:s + gap] = 0.0
            mask = torch.from_numpy(mask).to(dev)
            y_masked = xt * mask
            rec = tester.sampler.predict_inpainting(y_masked, mask, gen)

    signals = {"original": x[0], "degraded": y_masked[0].float().cpu().numpy(),
               "reconstructed": rec[0].float().cpu().numpy()}
    paths = {}
    for name, sig in signals.items():
        fp = logu.write_audio_file(sig, fs, name, cli.out)
        logu.plot_spectrogram_from_raw_audio(sig, fs, fp + ".png", title=name)
        paths[name] = fp
        print("wrote", fp, flush=True)
    return {"paths": paths, "signals": signals, "fs": fs}


def main(argv=None) -> int:
    run(parse(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
