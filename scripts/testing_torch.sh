#!/bin/bash
# Long-gap evaluation launcher of the PyTorch port: the twin of
# scripts/testing.sh (the reference's SLURM testing.sh:48-55) over
# python -m aid_tpu_torch.test, with the same config groups; overrides given
# to this script come last. Runs on a CUDA device; PYTHON names the
# interpreter (default python3).
#
#   CKPT=released.pt scripts/testing_torch.sh dset.path=/data/maestro/v3.0.0
set -euo pipefail
cd "$(dirname "$0")/.."

MODEL_DIR=${MODEL_DIR:-experiments/cqt}
CKPT=${CKPT:-}   # a reference .pt, the port's {exp}-{it}.pt or a .ckpt dir; empty = latest in MODEL_DIR

exec "${PYTHON:-python3}" -m aid_tpu_torch.test \
  model_dir="$MODEL_DIR" \
  dset=maestro_allyears \
  exp=maestro22k_8s \
  network=cqtdiff_plus_22k \
  tester=inpainting_tester \
  tester.checkpoint="$CKPT" \
  "$@"
