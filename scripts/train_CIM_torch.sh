#!/usr/bin/env bash
# Train CIM with the PyTorch port (scripts/train_CIM.sh's twin; reference
# scripts/train_CIM.sh). DEVICE: cuda (the default) or cpu.
set -euo pipefail

cfg_file=${CFG:-./configs/resnet50_voc.yaml}
dataset=${DATASET:-voc2012trainaug}
device=${DEVICE:-cuda}

python -m cim_tpu_torch.tools.train \
  --dataset "${dataset}" \
  --cfg "${cfg_file}" \
  --device "${device}" "$@"
