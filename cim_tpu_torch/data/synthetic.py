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
import torch

from cim_tpu_torch.ops.mask_iou import mask_iou_matrices


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


def masks_to_7x7(masks, boxes, size=7):
    """Rasterize full-res proposal masks to size x size bool crops (7x7 by
    default): each mask cropped to its inclusive box, nearest-resized
    (reference tools/pre/generate_7_7_voc.py:14-47 semantics)."""
    n = masks.shape[0]
    out = np.zeros((n, size, size), bool)
    for i in range(n):
        x1, y1, x2, y2 = boxes[i].astype(int)
        crop = masks[i, y1 : y2 + 1, x1 : x2 + 1]
        h, w = crop.shape
        ys = np.clip((np.arange(size) + 0.5) * h / size, 0, h - 1).astype(int)
        xs = np.clip((np.arange(size) + 0.5) * w / size, 0, w - 1).astype(int)
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
    iou, asy = (m.numpy() for m in mask_iou_matrices(torch.from_numpy(masks_full)))
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


def _save_cob_mat(path, masks):
    """Write (n, h, w) bool masks as a COB file holds them: a compressed
    cell array ``maskmat`` of n x 1 uint8 masks. Returns the seconds taken."""
    import time

    from scipy.io import savemat

    t0 = time.perf_counter()
    cell = np.empty((len(masks), 1), object)
    for i, m in enumerate(masks):
        cell[i, 0] = m.view(np.uint8)
    savemat(path, {"maskmat": cell}, do_compression=True)
    return time.perf_counter() - t0


def write_synthetic_train_dataset(data_dir, n_images, n_props, rng, image_hw=(96, 128),
                                  n_categories=20, iou_fn=None, cob_dir=None):
    """On-disk synthetic training set, as the real training path reads it:
    per image a JPEG, ``n_props`` COB-style mask proposals (boxes, 7x7
    rasterizations and scores in props.pkl), a PCL cluster matrix
    (label_assign.pkl) and its IoU and asymmetric-IoU matrices as float16
    pickles (iou/, asy/), and in ann.json two gt objects an image, whose
    classes are its image-level labels. Images have VOC ids and names
    (2012000001 is 2012_000001.jpg), and a VOC devkit of the same gt
    (devkit/VOC2012: Annotations/*.xml, ImageSets/Main/trainaug.txt) serves
    the CorLoc protocol of a set registered as voc_2012_trainaug. With
    ``cob_dir``, each image's full-resolution proposal masks also go there
    as a compressed .mat named by the VOC scheme of tools/evaluation.py
    (2012_000001.mat, maskmat[:, 0]), written in threads while the next
    image is drawn. iou_fn(masks (n, h, w) bool) -> (iou, asy) float
    arrays or CPU tensors; by default ops.mask_iou.mask_iou_matrices on the
    CPU (an O(n^2 h w) product: pass one that runs on a card at full size). Returns {image_dir, ann,
    props, label_assign, iou_dir, asy_iou_dir, devkit_dir, cob_dir,
    cob_write_s (the seconds of each .mat write)}."""
    import json
    import os
    import pickle
    from concurrent.futures import ThreadPoolExecutor

    import cv2

    from cim_tpu_torch.data.voc_meta import classes_for
    from cim_tpu_torch.evaluation import rle as rle_util

    iou_fn = iou_fn or (lambda m: mask_iou_matrices(torch.from_numpy(m)))
    paths = {"image_dir": os.path.join(data_dir, "images"), "ann": os.path.join(data_dir, "ann.json"),
             "props": os.path.join(data_dir, "props.pkl"),
             "label_assign": os.path.join(data_dir, "label_assign.pkl"),
             "iou_dir": os.path.join(data_dir, "iou"), "asy_iou_dir": os.path.join(data_dir, "asy"),
             "devkit_dir": os.path.join(data_dir, "devkit"), "cob_dir": cob_dir}
    voc_dir = os.path.join(paths["devkit_dir"], "VOC2012")
    for d in (paths["image_dir"], paths["iou_dir"], paths["asy_iou_dir"], cob_dir,
              os.path.join(voc_dir, "Annotations"), os.path.join(voc_dir, "ImageSets", "Main")):
        if d is not None:
            os.makedirs(d, exist_ok=True)
    h, w = image_hw
    class_names = classes_for(n_categories)
    images, annotations, names = [], [], []
    prop = {"indexes": [], "boxes": [], "masks": [], "scores": []}
    mats = {"indexes": [], "mat": []}
    writes = []
    with ThreadPoolExecutor(max_workers=4) as pool:
        for i in range(n_images):
            image_id = 2012000001 + i
            name = f"2012_{i + 1:06d}"
            names.append(name)
            cv2.imwrite(os.path.join(paths["image_dir"], name + ".jpg"),
                        (rng.rand(h, w, 3) * 255).astype(np.uint8))
            images.append({"id": image_id, "width": w, "height": h, "file_name": name + ".jpg"})
            masks, boxes = synthetic_masks(rng, n_props, h, w)
            if cob_dir is not None:
                writes.append(pool.submit(_save_cob_mat, os.path.join(cob_dir, name + ".mat"),
                                          masks))
            iou, asy = iou_fn(masks)
            for d, m in ((paths["iou_dir"], iou), (paths["asy_iou_dir"], asy)):
                with open(os.path.join(d, name + ".pkl"), "wb") as f:
                    pickle.dump(np.asarray(m, np.float16), f)
            prop["indexes"].append(image_id)
            prop["boxes"].append(boxes)
            prop["masks"].append(masks_to_7x7(masks, boxes).astype(np.float32))
            prop["scores"].append(rng.rand(n_props).astype(np.float32))
            mat = np.zeros((n_props, n_categories + 1), np.float32)
            mat[0, int(rng.randint(0, 3)) + 1] = 1
            mats["indexes"].append(image_id)
            mats["mat"].append(mat)
            objs = []
            for j in range(2):
                b = boxes[j]
                cat = (i + j) % n_categories + 1
                annotations.append({
                    "id": len(annotations) + 1, "image_id": image_id, "category_id": cat,
                    "bbox": [float(b[0]), float(b[1]), float(b[2] - b[0] + 1),
                             float(b[3] - b[1] + 1)],
                    "segmentation": rle_util.encode(masks[j].astype(np.uint8)),
                    "area": float(masks[j].sum()), "iscrowd": 0,
                })
                # VOC xml boxes are 1-based
                objs.append(f"<object><name>{class_names[cat - 1]}</name><difficult>0</difficult>"
                            f"<bndbox><xmin>{b[0] + 1:.0f}</xmin><ymin>{b[1] + 1:.0f}</ymin>"
                            f"<xmax>{b[2] + 1:.0f}</xmax><ymax>{b[3] + 1:.0f}</ymax>"
                            "</bndbox></object>")
            with open(os.path.join(voc_dir, "Annotations", name + ".xml"), "w") as f:
                f.write("<annotation>" + "".join(objs) + "</annotation>")
        paths["cob_write_s"] = [f.result() for f in writes]
    with open(os.path.join(voc_dir, "ImageSets", "Main", "trainaug.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    with open(paths["ann"], "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": c + 1, "name": f"c{c}"} for c in range(n_categories)]}, f)
    with open(paths["props"], "wb") as f:
        pickle.dump(prop, f)
    with open(paths["label_assign"], "wb") as f:
        pickle.dump(mats, f)
    return paths


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
