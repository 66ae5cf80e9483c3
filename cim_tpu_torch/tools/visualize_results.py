"""Visualization CLI (port of tools/visualize_results.py; reference
visualize/vis_json_mmcv.py and scripts/visual_result_mmcv.sh).

    python -m cim_tpu_torch.tools.visualize_results --result_file segm_results.json \\
        --image_dir data/VOC2012/JPEGImages --save_dir vis/

Draws the results of a COCO result JSON (evaluation's segm_results.json,
or a pseudo-label file) over their images into --save_dir.
"""
from __future__ import annotations

import argparse

from cim_tpu_torch.utils.visualize import visualize_result_file


def main(argv=None):
    """Run the CLI; returns the number of images drawn."""
    parser = argparse.ArgumentParser(description="Visualize result JSON")
    parser.add_argument("--result_file", required=True)
    parser.add_argument("--image_dir", required=True)
    parser.add_argument("--save_dir", required=True)
    parser.add_argument("--num_classes", type=int, default=20)
    parser.add_argument("--score_thr", type=float, default=0.3)
    parser.add_argument("--max_images", type=int, default=None)
    args = parser.parse_args(argv)
    n = visualize_result_file(args.result_file, args.image_dir, args.save_dir,
                              num_classes=args.num_classes, score_thr=args.score_thr,
                              max_images=args.max_images)
    print(f"rendered {n} images -> {args.save_dir}")
    return n


if __name__ == "__main__":
    main()
