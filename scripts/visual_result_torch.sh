#!/usr/bin/env bash
# Render result-JSON visualizations with the PyTorch port
# (scripts/visual_result.sh's twin; reference scripts/visual_result_mmcv.sh).
# Host only: it takes no DEVICE.
set -euo pipefail

result_file=${RESULT:-./Outputs/resnet50_voc/test/segm_results.json}
image_dir=${IMAGE_DIR:-./data/VOC2012/JPEGImages}
save_dir=${SAVE_DIR:-./vis_results}
score_thr=${SCORE_THR:-0.3}

python -u -m cim_tpu_torch.tools.visualize_results \
  --result_file "${result_file}" \
  --image_dir "${image_dir}" \
  --save_dir "${save_dir}" \
  --score_thr "${score_thr}"
