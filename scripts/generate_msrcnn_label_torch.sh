#!/usr/bin/env bash
# Export pseudo labels for Mask R-CNN refinement with the PyTorch port
# (scripts/generate_msrcnn_label.sh's twin; reference
# scripts/generate_msrcnn_label.sh). DEVICE: cuda (the default) or cpu,
# for test_net.
set -euo pipefail

cfg_file=${CFG:-./configs/resnet50_voc.yaml}
output_dir=${OUTPUT:-./Outputs/resnet50_voc}
cob_dir=${COB_DIR:-./data/VOC2012/COB_SBD_trainaug}
device=${DEVICE:-cuda}

# discovery.pkl over the TRAIN set (CorLoc protocol)
python -u -m cim_tpu_torch.tools.test_net \
  --cfg "${cfg_file}" \
  --load_ckpt "${output_dir}/ckpt" \
  --dataset voc2012trainaug \
  --output_dir "${output_dir}/discovery" \
  --device "${device}"

python -m cim_tpu_torch.tools.generate_mask_for_MaskRCNN \
  --cfg "${cfg_file}" \
  --result_path "${output_dir}/discovery/discovery.pkl" \
  --dataset voc2012trainaug \
  --cob_dir "${cob_dir}" \
  --output_dir "${output_dir}/pseudo_labels"

# keep annotations scoring >= 0.3 (the shipped pipeline's threshold)
python -m cim_tpu_torch.tools.change_mask_thr \
  --input "${output_dir}/pseudo_labels/msrcnn_pseudo_label.json" \
  --thr 0.3
