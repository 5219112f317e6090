"""Evaluation entry point of the port.

    python -m aid_tpu_torch.test [group=name ...] [dotted.key=value ...]
e.g.
    python -m aid_tpu_torch.test tester.modes=['inpainting','bwe'] \\
        dset.path=/data/maestro/v3.0.0 model_dir=experiments/a

Composes the port's config tree, then setup_{diff_parameters, network,
dataset_test, tester} and ``Tester.dodajob``. Checkpoint: an explicit
``tester.checkpoint`` (a reference-layout ``.pt``, the port's own
``{exp}-{it}.pt`` or a JAX stream ``.ckpt`` directory) wins; otherwise the
latest checkpoint in ``model_dir``; without one it warns and runs on
seeded random weights. Outputs go under ``model_dir/test/<date>/<mode>/``.
"""
from __future__ import annotations

import sys
from typing import Optional, Sequence

from aid_tpu_torch import setup as tsetup
from aid_tpu_torch.utils.config import compose


def main(overrides: Optional[Sequence[str]] = None, device=None) -> int:
    """Run the configured tester modes on CUDA (``device`` names another, as
    the CPU tests do; without CUDA and without ``device`` this raises)."""
    args = compose(overrides=list(sys.argv[1:] if overrides is None else overrides))
    dev = tsetup.resolve_device(device)
    print(f"device: {dev}", flush=True)
    diff_params = tsetup.setup_diff_parameters(args)
    network = tsetup.setup_network(args, device=dev, seed=int(args.exp.get("seed", 42)))
    tester = tsetup.setup_tester(args, network=network, diff_params=diff_params,
                                 test_set=tsetup.setup_dataset_test(args), device=dev)
    if tester is None:
        print("tester.do_test is False; nothing to do", flush=True)
        return 0
    if not (tester.load_checkpoint() or tester.load_latest_checkpoint()):
        print("WARNING: no checkpoint found - running with random weights", flush=True)
    for mode, res in tester.dodajob().items():
        n = len(res) if isinstance(res, list) else res
        print(f"{mode}: {n} -> {tester.base_dir}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
