#!/bin/bash
# Short-gap evaluation launcher of the PyTorch port: the twin of
# scripts/testing_shortgaps.sh (the reference's testing_shortgaps.sh:36-77:
# T=70, hann 100, a mask-providing dataset: dset.test.path holds the wavs,
# dset.test.mask_path one .npy or .mat mask per file stem) over
# python -m aid_tpu_torch.test. Runs on a CUDA device; PYTHON names the
# interpreter (default python3).
set -euo pipefail
cd "$(dirname "$0")/.."

MODEL_DIR=${MODEL_DIR:-experiments/cqt}
CKPT=${CKPT:-}   # empty = latest in MODEL_DIR

exec "${PYTHON:-python3}" -m aid_tpu_torch.test \
  model_dir="$MODEL_DIR" \
  dset=inpainting_mask_dataset \
  exp=musicnet44k_4s \
  network=cqtdiff_plus_44k \
  tester=inpainting_tester_shortgaps \
  tester.checkpoint="$CKPT" \
  "$@"
