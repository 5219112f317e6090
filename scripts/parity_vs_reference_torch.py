"""Checkpoint parity on the PyTorch port: run the f32 denoiser of a
reference ``.pt`` on a fixed seeded input at several noise levels, so that
the same tensors from the JAX package's ``scripts/parity_vs_reference.py``,
or from the reference code, can be diffed on any machine.

    python scripts/parity_vs_reference_torch.py --pt maestro_22k_8s-750000.pt \
        [--network cqtdiff_plus_22k --exp maestro22k_8s] [--export out.npz] \
        [--compare ref.npz] [--device cpu]

The input and the draw order are the JAX script's: ``np.random.default_rng
(1234)``, x = 0.063 N(0, 1) of one window, then per sigma in
[1e-3, 1e-2, 0.1, 0.5, 1.0] the noisy input x + sigma N(0, 1) through
D(x, sigma), in f32 with TF32 off. ``--export`` writes x, sigmas and
denoised[s, b, t] to an ``.npz`` (the JAX script's keys); ``--compare``
fails unless the largest absolute difference from another export's
``denoised`` is below 1e-3.
"""
import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

SIGMAS = np.asarray([1e-3, 1e-2, 1e-1, 0.5, 1.0], np.float32)
COMPARE_TOL = 1e-3


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pt", required=True)
    ap.add_argument("--network", default="cqtdiff_plus_22k")
    ap.add_argument("--exp", default="maestro22k_8s")
    ap.add_argument("--export", default=None)
    ap.add_argument("--compare", default=None,
                    help=".npz with a reference 'denoised' to diff against")
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: CUDA)")
    return ap.parse_args(argv)


def run(cli: argparse.Namespace, overrides=()) -> dict:
    """The denoised tensors of ``cli.pt``; raises when ``--compare`` fails.
    ``overrides`` are appended to the composed config."""
    from aid_tpu_torch import setup as tsetup
    from aid_tpu_torch.diffusion import edm
    from aid_tpu_torch.utils import checkpoint_torch
    from aid_tpu_torch.utils.config import compose

    dev = tsetup.resolve_device(cli.device)
    torch.backends.cuda.matmul.allow_tf32 = False    # parity runs are f32
    torch.backends.cudnn.allow_tf32 = False
    args = compose(overrides=[f"network={cli.network}", f"exp={cli.exp}",
                              "network.compute_dtype=float32",
                              f"model_dir={os.path.join(tempfile.gettempdir(), 'aid_tpu_parity')}",
                              *overrides])
    L = int(args.exp.audio_len)
    net = tsetup.setup_network(args, device=dev, seed=0)
    checkpoint_torch.load_reference_checkpoint(cli.pt, net)
    print(f"loaded {cli.pt}", flush=True)
    p = tsetup.setup_diff_parameters(args).params

    rng = np.random.default_rng(1234)
    x = (rng.standard_normal((1, L)) * 0.063).astype(np.float32)
    outs = []
    for s in SIGMAS:
        xn = x + s * rng.standard_normal((1, L)).astype(np.float32)
        with torch.no_grad():
            d = edm.denoiser(p, net, torch.from_numpy(xn).to(dev),
                             torch.full((1, 1), float(s), device=dev))
        d = d.float().cpu().numpy()
        outs.append(d)
        print(f"sigma={s:8.4f}  |D|_max={np.abs(d).max():.5f} std={d.std():.5f}", flush=True)
    den = np.stack(outs)
    out = {"x": x, "sigmas": SIGMAS, "denoised": den}
    if cli.export:
        np.savez(cli.export, **out)
        print("exported", cli.export, flush=True)
    if cli.compare:
        ref = np.load(cli.compare)["denoised"]
        diff = np.abs(den - ref)
        out["max_abs_diff"] = float(diff.max())
        print(f"max-abs-diff vs reference: {diff.max():.3e} "
              f"(rel {diff.max() / (np.abs(ref).max() + 1e-12):.3e})", flush=True)
        if not diff.max() < COMPARE_TOL:
            raise SystemExit("parity FAILED")
        print("parity OK", flush=True)
    return out


def main(argv=None) -> int:
    run(parse(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
