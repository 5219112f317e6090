#!/bin/bash
# Training launcher of the PyTorch port: the twin of scripts/training.sh (the
# reference's SLURM training.sh:37-47) over python -m aid_tpu_torch.train,
# with the same config groups; overrides given to this script come last.
#
#   one card:           scripts/training_torch.sh dset.path=/data/maestro/v3.0.0
#   N cards, one host:  NPROC=N scripts/training_torch.sh ...
#   M hosts of N cards: on each host, NNODES=M NODE_RANK=<0..M-1> NPROC=N
#                       MASTER_ADDR=<host of node 0> scripts/training_torch.sh ...
#
# With NPROC and NNODES both 1 the module runs in one process. Otherwise
# torch.distributed.run starts NPROC ranks on this host (every host runs this
# same script with its own NODE_RANK) and the overrides add
# exp.mesh.dp=NPROC*NNODES exp.mesh.distributed=true: DDP, or FSDP2 with
# exp.mesh.fsdp=true. Ranks that outnumber a host's cards share them over gloo.
# PYTHON names the interpreter (default python3).
set -euo pipefail
cd "$(dirname "$0")/.."

MODEL_DIR=${MODEL_DIR:-experiments/cqt}
NPROC=${NPROC:-1}
NNODES=${NNODES:-1}
mkdir -p "$MODEL_DIR"

OVERRIDES=(
  model_dir="$MODEL_DIR"
  dset=maestro_allyears
  exp=maestro22k_8s
  network=cqtdiff_plus_22k
  tester=inpainting_tester
  logging=huge_model_logging
)

if [ "$NPROC" = 1 ] && [ "$NNODES" = 1 ]; then
  exec "${PYTHON:-python3}" -m aid_tpu_torch.train \
    "${OVERRIDES[@]}" \
    "$@"
fi
exec "${PYTHON:-python3}" -m torch.distributed.run \
  --nnodes "$NNODES" --node-rank "${NODE_RANK:-0}" --nproc-per-node "$NPROC" \
  --master-addr "${MASTER_ADDR:-127.0.0.1}" --master-port "${MASTER_PORT:-29500}" \
  -m aid_tpu_torch.train \
  "${OVERRIDES[@]}" \
  exp.mesh.dp=$((NPROC * NNODES)) exp.mesh.distributed=true \
  "$@"
