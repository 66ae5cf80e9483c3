"""Synthetic fixture generation: images + COB-style proposals + IoU maps.

Serves three purposes:
1. unit/integration tests without VOC/COCO data on disk;
2. `bench.py` inputs at production shapes;
3. a template of the exact batch layout the host pipeline must emit
   (fixed shapes: image padded to a scale bucket, proposals padded to
   N_max with a validity mask, per-image IoU matrices bundled *into the
   batch* — the reference instead reloads them from pickles inside
   forward, lib/modeling/model_builder.py:147-159).
"""
from __future__ import annotations

import numpy as np


def synthetic_masks(rng, n, h, w, min_frac=0.05, max_frac=0.6):
    """Random axis-aligned blobby masks (N, h, w) bool + tight boxes."""
    masks = np.zeros((n, h, w), bool)
    boxes = np.zeros((n, 4), np.float32)
    for i in range(n):
        mh = max(2, int(rng.uniform(min_frac, max_frac) * h))
        mw = max(2, int(rng.uniform(min_frac, max_frac) * w))
        y0 = rng.randint(0, h - mh + 1)
        x0 = rng.randint(0, w - mw + 1)
        masks[i, y0 : y0 + mh, x0 : x0 + mw] = True
        # carve a random corner off to make masks non-rectangular
        ch = max(1, mh // 3)
        cw = max(1, mw // 3)
        if rng.rand() < 0.7:
            masks[i, y0 : y0 + ch, x0 : x0 + cw] = False
        ys, xs = np.nonzero(masks[i])
        boxes[i] = [xs.min(), ys.min(), xs.max(), ys.max()]
    return masks, boxes


def mask_matrices(masks):
    """(iou, asy_iou) float32 matrices from (N, h, w) masks
    (same math as cim_tpu.ops.mask_iou, on host for fixtures)."""
    flat = masks.reshape(masks.shape[0], -1).astype(np.float32)
    inter = flat @ flat.T
    area = flat.sum(-1)
    union = area[:, None] + area[None, :] - inter
    iou = inter / np.maximum(union, 1)
    asy = inter / np.maximum(area[None, :], 1)
    return iou, asy


def masks_to_7x7(masks, boxes):
    """Rasterize full-res proposal masks to 7x7 bool crops, nearest-resize
    (reference tools/pre/generate_7_7_voc.py:14-47 semantics)."""
    n = masks.shape[0]
    out = np.zeros((n, 7, 7), bool)
    for i in range(n):
        x1, y1, x2, y2 = boxes[i].astype(int)
        crop = masks[i, y1 : y2 + 1, x1 : x2 + 1]
        h, w = crop.shape
        ys = np.clip((np.arange(7) + 0.5) * h / 7, 0, h - 1).astype(int)
        xs = np.clip((np.arange(7) + 0.5) * w / 7, 0, w - 1).astype(int)
        out[i] = crop[np.ix_(ys, xs)]
    return out


def make_microbatch(
    rng,
    image_hw=(224, 224),
    n_props=64,
    n_valid=None,
    num_classes=20,
    n_labels=2,
    max_clusters=8,
    mask_grid=64,
):
    """One training microbatch (host numpy, fixed shapes).

    Masks are generated on a coarse `mask_grid`-limited grid and their
    boxes scaled up to image coordinates — the N x N IoU matrices are an
    O(N^2 * grid^2) host matmul, prohibitive at full image resolution for
    bench-scale N (2000+ proposals)."""
    h, w = image_hw
    n_valid = n_valid if n_valid is not None else n_props
    image = rng.randn(h, w, 3).astype(np.float32)

    gh = min(h, mask_grid)
    gw = min(w, mask_grid)
    masks_full, boxes = synthetic_masks(rng, n_valid, gh, gw)
    iou, asy = mask_matrices(masks_full)
    masks7 = masks_to_7x7(masks_full, boxes)
    # scale boxes from the mask grid up to image coordinates
    boxes = boxes * np.array(
        [w / gw, h / gh, w / gw, h / gh], np.float32
    )

    labels = np.zeros(num_classes, np.float32)
    labels[rng.choice(num_classes, n_labels, replace=False)] = 1

    # PCL cluster matrix: a few clusters on present classes + a bg cluster
    mat = np.zeros((n_valid, num_classes + 1), np.int32)
    present = np.nonzero(labels)[0]
    cid = 1
    for c in present:
        members = rng.choice(n_valid, max(1, n_valid // 8), replace=False)
        mat[members, c + 1] = cid
        cid += 1
    bg_members = rng.choice(n_valid, max(1, n_valid // 8), replace=False)
    mat[bg_members, 0] = cid

    pad = n_props - n_valid

    def padrows(x, fill=0):
        if pad == 0:
            return x
        return np.concatenate(
            [x, np.full((pad,) + x.shape[1:], fill, x.dtype)], axis=0
        )

    def padmat(m):
        if pad == 0:
            return m
        out = np.zeros((n_props, n_props), m.dtype)
        out[:n_valid, :n_valid] = m
        return out

    valid = np.zeros(n_props, bool)
    valid[:n_valid] = True

    return {
        "image": image,
        "image_hw": np.array([h, w], np.int32),
        "rois": padrows(boxes.astype(np.float32)),
        "masks": padrows(masks7).astype(np.float32),
        "valid": valid,
        "labels": labels,
        "mat": padrows(mat),
        # f16 storage (reference stores f16 pkls too); cast at use
        "iou_map": padmat(iou).astype(np.float16),
        "asy_iou_map": padmat(asy).astype(np.float16),
    }


def make_train_batch(rng, n_devices, grad_accum, **kw):
    """Stacked batch with leading (n_devices, grad_accum) dims."""
    mbs = [
        [make_microbatch(rng, **kw) for _ in range(grad_accum)]
        for _ in range(n_devices)
    ]
    out = {}
    for key in mbs[0][0]:
        out[key] = np.stack(
            [np.stack([mb[key] for mb in row]) for row in mbs]
        )
    return out


def write_synthetic_coco_dataset(data_dir, n_images, n_props, rng,
                                 image_hw=(64, 96), write_jpegs=False,
                                 n_categories=20):
    """On-disk synthetic COCO-json dataset + COB-style proposal pkl.

    Shared by the eval harnesses (tools/bench_eval.py e2e mode,
    tools/multihost_dryrun.py eval mode): per image, `n_props` synthetic
    mask proposals (boxes + 7x7 rasterizations + scores) and 2 gt
    annotations taken from the first proposals (1-based wh bbox
    convention, RLE segmentation). write_jpegs=True additionally writes
    real JPEG files so decode cost is part of the measured pipeline;
    otherwise callers feed images through an image_loader.
    Returns (ann_path, props_path)."""
    import json
    import os
    import pickle

    from cim_tpu_torch.evaluation import rle as rle_util

    h, w = image_hw
    images, annotations, aid = [], [], 1
    prop = {"indexes": [], "boxes": [], "masks": [], "scores": []}
    for i in range(n_images):
        name = f"{i:06d}.jpg"
        if write_jpegs:
            import cv2

            cv2.imwrite(
                os.path.join(data_dir, name),
                (rng.rand(h, w, 3) * 255).astype(np.uint8),
            )
        images.append({"id": i + 1, "width": w, "height": h,
                       "file_name": name})
        masks, boxes = synthetic_masks(rng, n_props, h, w)
        prop["indexes"].append(i + 1)
        prop["boxes"].append(boxes)
        prop["masks"].append(masks_to_7x7(masks, boxes).astype(np.float32))
        prop["scores"].append(rng.rand(n_props).astype(np.float32))
        for j in range(2):
            b = boxes[j]
            annotations.append({
                "id": aid, "image_id": i + 1, "category_id": (j % 3) + 1,
                "bbox": [float(b[0]), float(b[1]),
                         float(b[2] - b[0] + 1), float(b[3] - b[1] + 1)],
                "segmentation": rle_util.encode(masks[j].astype(np.uint8)),
                "area": float(masks[j].sum()), "iscrowd": 0,
            })
            aid += 1
    ann_path = os.path.join(data_dir, "ann.json")
    with open(ann_path, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": c + 1, "name": f"c{c}"}
                                  for c in range(n_categories)]}, f)
    props_path = os.path.join(data_dir, "props.pkl")
    with open(props_path, "wb") as f:
        pickle.dump(prop, f)
    return ann_path, props_path
