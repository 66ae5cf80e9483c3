"""Detection and segmentation drawings (port of cim_tpu/utils/visualize.py;
reference visualize/vis_json_mmcv.py and mmcv's imshow_det_bboxes /
BitmapMasks): a COCO result JSON rendered over its images, class-coloured
mask overlays, boxes and score labels, with PIL."""
from __future__ import annotations

import json
import os

import numpy as np

from cim_tpu_torch.data.voc_meta import VOC_PALETTE, classes_for
from cim_tpu_torch.evaluation import rle as rle_util


def _color(idx):
    return VOC_PALETTE[(idx + 1) % len(VOC_PALETTE)]


def draw_detections(image, dets, class_names, score_thr: float = 0.3, mask_alpha: float = 0.45):
    """image: (H, W, 3) uint8 RGB; dets: dicts with 'category_id'
    (1-indexed contiguous), 'score', optional 'bbox' (xywh) and optional
    'segmentation' (RLE). Returns a PIL.Image."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(image.astype(np.uint8)).convert("RGB")
    overlay = np.asarray(img).astype(np.float32)

    kept = [d for d in dets if d.get("score", 1.0) >= score_thr]
    for d in kept:
        color = np.array(_color(int(d["category_id"]) - 1), np.float32)
        if "segmentation" in d:
            mask = rle_util.decode(d["segmentation"]).astype(bool)
            overlay[mask] = (1 - mask_alpha) * overlay[mask] + mask_alpha * color

    img = Image.fromarray(overlay.astype(np.uint8))
    draw = ImageDraw.Draw(img)
    for d in kept:
        cat = int(d["category_id"]) - 1
        color = tuple(_color(cat))
        if d.get("bbox") is not None:
            x, y, w, h = d["bbox"]
            draw.rectangle([x, y, x + w, y + h], outline=color, width=2)
            draw.text((x + 2, max(0, y - 12)), f"{class_names[cat]} {d.get('score', 0):.2f}",
                      fill=color)
    return img


def visualize_result_file(result_file: str, image_dir: str, save_dir: str, num_classes: int = 20,
                          score_thr: float = 0.3, id_to_filename=None,
                          max_images: int | None = None):
    """Render every image of a COCO result JSON (a list of results, or a
    dataset's {"annotations": [...]}) into save_dir; returns the count.
    Images are found by id: YYYY_NNNNNN.jpg for VOC (20 classes), the
    12-digit id .jpg for COCO, unless id_to_filename(id) names them."""
    from PIL import Image

    with open(result_file) as f:
        results = json.load(f)
    if isinstance(results, dict):
        results = results.get("annotations", [])
    by_img = {}
    for r in results:
        by_img.setdefault(r["image_id"], []).append(r)

    class_names = classes_for(num_classes)
    os.makedirs(save_dir, exist_ok=True)
    count = 0
    for img_id, dets in by_img.items():
        if max_images is not None and count >= max_images:
            break
        if id_to_filename is not None:
            fname = id_to_filename(img_id)
        else:
            s = str(int(img_id))
            fname = (s[:4] + "_" + s[4:] + ".jpg") if num_classes == 20 else f"{int(img_id):012d}.jpg"
        path = os.path.join(image_dir, fname)
        if not os.path.exists(path):
            continue
        out = draw_detections(np.asarray(Image.open(path).convert("RGB")), dets, class_names,
                              score_thr)
        out.save(os.path.join(save_dir, fname))
        count += 1
    return count
