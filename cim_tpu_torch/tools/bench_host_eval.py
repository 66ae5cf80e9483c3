"""Host-side eval cost at dataset scale (port of tools/bench_host_eval.py;
no card needed).

    python -m cim_tpu_torch.tools.bench_host_eval --images 2000

The card's side of eval is bench_eval's (s/image of the 10-pass TTA). This
times everything after the card: a image's score threshold, per-class NMS
and top-K (engine.test.box_results_with_nms_and_limit, reference
lib/core/test.py:355-423), the instance-seg path (mask NMS keeping the
proposal indices and the RLE encode of a full-size mask a kept detection,
tools.evaluation.eval_shard's inner loop), and COCOeval('segm') over
--coco_images, on synthetic production-shape score tensors (2000
proposals x 20 classes, peaked as TTA-averaged scores are). Prints one
JSON line with ms/image a stage, images/s of one host core, and the
kept-detection and RLE counts an image.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from cim_tpu_torch.config import clone_cfg, get_default_cfg
from cim_tpu_torch.engine.test import box_results_with_nms_and_limit
from cim_tpu_torch.evaluation import rle as rle_util
from cim_tpu_torch.evaluation.coco import COCO, COCOeval
from cim_tpu_torch.evaluation.mask_results import (
    coco_encode,
    mask_results_with_nms_and_limit_get_index,
)


def synth_scores(rng, n_props, n_classes, peaked=8):
    """TTA-averaged score tensors are peaked: a handful of proposals carry
    mass a present class, the rest sit near the 1e-5 threshold."""
    scores = rng.gamma(0.3, 2e-4, size=(n_props, n_classes)).astype(np.float32)
    present = rng.choice(n_classes, 3, replace=False)
    for c in present:
        hot = rng.choice(n_props, peaked, replace=False)
        scores[hot, c] = rng.uniform(0.1, 0.9, peaked)
    return scores


def synth_image(rng, n_props, n_classes, h=375, w=500):
    x1 = rng.uniform(0, w - 20, n_props)
    y1 = rng.uniform(0, h - 20, n_props)
    bw = rng.uniform(8, w / 2, n_props)
    bh = rng.uniform(8, h / 2, n_props)
    boxes = np.stack(
        [x1, y1, np.minimum(x1 + bw, w - 1), np.minimum(y1 + bh, h - 1)], 1
    ).astype(np.float32)
    return boxes, synth_scores(rng, n_props, n_classes)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--images", type=int, default=2000)
    ap.add_argument("--n_props", type=int, default=2000)
    ap.add_argument("--classes", type=int, default=20)
    ap.add_argument("--coco_images", type=int, default=300,
                    help="images of the COCOeval stage (it holds the RLEs in memory; "
                    "its cost scales linearly)")
    return ap.parse_args(argv)


def main(argv=None, log=print):
    """Run the three stages; returns the printed record."""
    args = parse_args(argv)
    cfg = clone_cfg(get_default_cfg())
    cfg.MODEL.NUM_CLASSES = args.classes

    rng = np.random.RandomState(0)
    data = [synth_image(rng, args.n_props, args.classes) for _ in range(args.images)]

    # stage 1: detection post-processing (box NMS + limit), a image
    t0 = time.time()
    kept = 0
    for boxes, scores in data:
        s, _, _ = box_results_with_nms_and_limit(cfg, scores, boxes)
        kept += len(s)
    t_det = time.time() - t0

    # stage 2: instance-seg post (mask NMS keeping the indices, and the
    # RLE of a full-size mask a kept detection)
    t0 = time.time()
    n_rles = 0
    # stand-ins for COB masks: connected elliptical blobs (a few hundred
    # RLE runs each, as real COB proposals have, not salt-and-pepper noise)
    yy, xx = np.mgrid[0:375, 0:500]
    mask_cache = np.stack([
        ((xx - rng.uniform(80, 420)) ** 2 / rng.uniform(20, 150) ** 2
         + (yy - rng.uniform(60, 310)) ** 2 / rng.uniform(20, 120) ** 2) < 1
        for _ in range(64)
    ])
    for boxes, scores in data:
        _, _, cls_boxes, cls_inds = mask_results_with_nms_and_limit_get_index(cfg, scores, boxes)
        for j in range(1, args.classes + 1):
            for _, idx in zip(cls_boxes[j], cls_inds[j]):
                coco_encode(mask_cache[int(idx) % len(mask_cache)].astype(np.uint8))
                n_rles += 1
    t_seg = time.time() - t0

    # stage 3: COCOeval('segm') over a subset (linear in images)
    nc = min(args.coco_images, args.images)
    images, gt_anns, results = [], [], []
    aid = 1
    for i in range(nc):
        images.append({"id": i + 1, "height": 375, "width": 500})
        boxes, scores = data[i]
        for k in range(2):
            m = mask_cache[(i + k) % len(mask_cache)].astype(np.uint8)
            gt_anns.append({
                "id": aid, "image_id": i + 1,
                "category_id": int(rng.randint(1, args.classes + 1)),
                "segmentation": rle_util.encode(m), "area": float(m.sum()),
                "iscrowd": 0,
            })
            aid += 1
        _, _, cls_boxes, cls_inds = mask_results_with_nms_and_limit_get_index(cfg, scores, boxes)
        for j in range(1, args.classes + 1):
            for d, idx in zip(cls_boxes[j][:5], cls_inds[j][:5]):
                results.append({
                    "image_id": i + 1, "category_id": j,
                    "segmentation": rle_util.encode(
                        mask_cache[int(idx) % len(mask_cache)].astype(np.uint8)),
                    "score": float(d[4]),
                })
    gt = COCO({
        "images": images, "annotations": gt_anns,
        "categories": [{"id": c + 1, "name": f"c{c}"} for c in range(args.classes)],
    })
    t0 = time.time()
    ev = COCOeval(gt, gt.loadRes(results), iouType="segm")
    ev.params.iouThrs = np.array([0.25, 0.5, 0.7, 0.75])
    ev.evaluate()
    ev.accumulate()
    t_coco = time.time() - t0

    ms_det = 1000 * t_det / args.images
    ms_seg = 1000 * t_seg / args.images
    ms_coco = 1000 * t_coco / nc
    total_ms = ms_det + ms_seg + ms_coco
    rec = {
        "metric": "host_eval_ms_per_image",
        "value": round(total_ms, 2),
        "unit": "ms/image (single host core)",
        "det_nms_ms": round(ms_det, 2),
        "inst_seg_ms": round(ms_seg, 2),
        "coco_eval_ms": round(ms_coco, 2),
        "images": args.images,
        "n_props": args.n_props,
        "kept_dets_mean": round(kept / args.images, 1),
        "rles_mean": round(n_rles / args.images, 1),
        "host_images_per_sec": round(1000.0 / total_ms, 2),
    }
    log(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
