#!/usr/bin/env bash
# Inference + instance-seg evaluation with the PyTorch port
# (scripts/eval_CIM.sh's twin; reference scripts/eval_CIM.sh).
# DEVICE: cuda (the default) or cpu, for test_net.
set -euo pipefail

cfg_file=${CFG:-./configs/resnet50_voc.yaml}
output_dir=${OUTPUT:-./Outputs/resnet50_voc}
dataset=${DATASET:-voc2012sbdval}
cob_dir=${COB_DIR:-./data/VOC2012/COB_SBD_val}
device=${DEVICE:-cuda}

ckpt=${output_dir}/ckpt
result_pkl=${output_dir}/test/detections.pkl

# generate detections.pkl on the test set (TTA)
python -u -m cim_tpu_torch.tools.test_net \
  --cfg "${cfg_file}" \
  --load_ckpt "${ckpt}" \
  --dataset "${dataset}" \
  --output_dir "${output_dir}/test" \
  --device "${device}"

# report instance-segmentation mAP@{25,50,70,75}
python -m cim_tpu_torch.tools.evaluation \
  --cfg "${cfg_file}" \
  --result_path "${result_pkl}" \
  --dataset "${dataset}" \
  --cob_dir "${cob_dir}"
