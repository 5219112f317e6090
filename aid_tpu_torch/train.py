"""Training entry point of the port.

    python -m aid_tpu_torch.train [group=name ...] [dotted.key=value ...]
e.g.
    python -m aid_tpu_torch.train dset.path=/data/maestro/v3.0.0 model_dir=experiments/a
    torchrun --nproc_per_node N -m aid_tpu_torch.train exp.mesh.dp=N [exp.mesh.fsdp=true]

Composes the port's config tree, then setup_{diff_parameters, network,
dataset, trainer} and ``Trainer.training_loop``. As the JAX entry
(``train.py``), it turns on ``network.remat`` and trains in
``network.compute_dtype=float32`` unless the overrides choose otherwise;
``dry_run=True`` prints the composed config and stops.

Under ``torchrun`` (``WORLD_SIZE`` > 1), with ``exp.mesh.distributed=true``
or ``AID_TPU_DISTRIBUTED=1`` the entry starts a process group first
(``parallel.mesh.init_distributed``) and the trainer splits ``exp.batch``
over the ranks (DDP, or FSDP2 with ``exp.mesh.fsdp=true``); rank 0 logs,
samples the demos and writes the checkpoints.

f32 training keeps PyTorch's defaults on the card: convolutions through
cuDNN in TF32, matrix products in full f32 (see README.md, "TF32").
"""
from __future__ import annotations

import json
import sys
from typing import Optional, Sequence

import torch.distributed as dist

from aid_tpu_torch import setup as tsetup
from aid_tpu_torch.parallel import mesh as pmesh
from aid_tpu_torch.utils.config import compose


def compose_args(overrides: Sequence[str]):
    """The training config: the composed tree with the entry's defaults."""
    args = compose(overrides=list(overrides))
    # training needs rematerialisation to fit the flagship at batch 4 on the
    # JAX package's 16 GB chip; serving keeps remat off for a faster backward
    if not any(o.startswith("network.remat=") for o in overrides):
        args.network["remat"] = True
    # bf16 compute drifted the JAX flagship run's gradient-norm scale and
    # spiked it; f32 held it (the JAX package's train.py)
    if not any(o.startswith("network.compute_dtype=") for o in overrides):
        args.network["compute_dtype"] = "float32"
        print("[train] network.compute_dtype=float32 (training default; override "
              "for mixed-precision experiments)", flush=True)
    return args


def main(overrides: Optional[Sequence[str]] = None, device=None) -> int:
    """Run the training loop on CUDA (``device`` names another, as the CPU
    tests do; without CUDA and without ``device`` this raises). A process
    group this call starts, it also ends."""
    args = compose_args(sys.argv[1:] if overrides is None else overrides)
    if bool(args.get("dry_run", False)):
        print(json.dumps(args, indent=1))
        return 0

    had_group = dist.is_initialized()
    pmesh.init_distributed(bool((args.exp.get("mesh", {}) or {}).get("distributed", False)),
                           device=device)
    started = dist.is_initialized() and not had_group
    try:
        dev = tsetup.resolve_device(device)
        print(f"device: {dev}", flush=True)
        diff_params = tsetup.setup_diff_parameters(args)
        network = tsetup.setup_network(args, device=dev,
                                       seed=int(args.exp.get("seed", 42)), trainable=True)
        dset = tsetup.setup_dataset(args)
        tester = (tsetup.setup_tester(args, network=network, diff_params=diff_params,
                                      device=dev, in_training=True)
                  if pmesh.rank() == 0 else None)
        trainer = tsetup.setup_trainer(args, dset=dset, network=network,
                                       diff_params=diff_params, tester=tester)
        final_it = trainer.training_loop()
        print(f"done at iteration {final_it}", flush=True)
    finally:
        if started:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
