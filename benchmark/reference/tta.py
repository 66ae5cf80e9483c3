"""The 10-pass TTA of one image and its detections (reference
lib/core/test.py im_detect_bbox_aug with AVG / ID, and
box_results_with_nms_and_limit), in plain PyTorch and NumPy.

A pass resizes the uint8 BGR image by s = target / max side (float32) with
cv2's INTER_LINEAR rule (half-pixel source coordinates, two taps an axis,
edge replication; the hflip folded into the source x), truncates to
uint8, converts to RGB, divides by 255 and normalizes, scales (and for
hflip flips about the image width) the boxes, flips the 7x7 masks, and
runs the model at the resized image's true size. Its scores are the mean
over refine branches of (refine_cls * refine_iou) without the background
column; the image's scores are the mean over passes.
"""
from __future__ import annotations

import numpy as np
import torch

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def pass_list(test: dict):
    """(target, hflip) of every pass, in the reference's order: hflip at
    TEST.SCALE, each aug scale and its hflip, then the identity."""
    passes = [(int(test["SCALE"]), True)] if test["H_FLIP"] else []
    for s in test["AUG_SCALES"]:
        passes.append((int(s), False))
        if test["SCALE_H_FLIP"]:
            passes.append((int(s), True))
    return passes + [(int(test["SCALE"]), False)]


def pass_geometry(h: int, w: int, target: int):
    """(scale, (out_h, out_w), (ratio_y, ratio_x)) of a pass, as float32
    host scalars: the output size rounds src * scale, and a destination
    pixel maps back with src / out."""
    scale = np.float32(target) / np.float32(max(h, w))
    oh = int(np.round(np.float32(h) * scale))
    ow = int(np.round(np.float32(w) * scale))
    return float(scale), (oh, ow), (float(np.float32(h) / np.float32(max(oh, 1))),
                                    float(np.float32(w) / np.float32(max(ow, 1))))


def _axis_matrix(out_len, src_len, ratio, flip, device):
    o = torch.arange(out_len, dtype=torch.float32, device=device)
    s = (o + 0.5) * ratio - 0.5
    if flip:
        s = (src_len - 1.0) - s
    s = s.clamp(0.0, src_len - 1.0)
    t0 = torch.floor(s)
    frac = s - t0
    t1 = torch.clamp(t0 + 1.0, max=src_len - 1.0)
    idx = torch.arange(src_len, dtype=torch.float32, device=device)[None, :]
    return (idx == t0[:, None]) * (1.0 - frac)[:, None] + (idx == t1[:, None]) * frac[:, None]


def pass_image(image_u8: torch.Tensor, target: int, hflip: bool):
    """image_u8 (h, w, 3) BGR -> the pass's normalized RGB float32 image
    at its true (out_h, out_w), and the scale."""
    h, w, _ = image_u8.shape
    scale, (oh, ow), (ry, rx) = pass_geometry(h, w, target)
    rgb = image_u8.flip(-1).float()
    my = _axis_matrix(oh, h, ry, False, rgb.device)
    mx = _axis_matrix(ow, w, rx, hflip, rgb.device)
    out = torch.einsum("pw,owc->opc", mx, torch.einsum("oh,hwc->owc", my, rgb))
    mean = torch.as_tensor(MEAN, device=rgb.device)
    std = torch.as_tensor(STD, device=rgb.device)
    return (torch.floor(out.clamp(0.0, 255.0)) / 255.0 - mean) / std, scale


@torch.no_grad()
def image_scores(model, image_u8, boxes, masks, test: dict, passes=None):
    """The (N, C) pass-averaged scores of one image: image_u8 (h, w, 3)
    uint8 BGR, boxes (N, 4) float32 image coordinates, masks (N, 7, 7).
    passes: the passes to average, where not all of pass_list's (the
    control test's planted fault)."""
    w = image_u8.shape[1]
    masks_f = torch.flip(masks, [-1])
    passes = pass_list(test) if passes is None else passes
    total = None
    for target, hflip in passes:
        img, scale = pass_image(image_u8, target, hflip)
        if hflip:
            b = torch.stack([w - boxes[:, 2] - 1, boxes[:, 1], w - boxes[:, 0] - 1, boxes[:, 3]],
                            dim=-1)
        else:
            b = boxes
        out = model(img, b * torch.tensor(scale, dtype=torch.float32, device=b.device),
                    masks_f if hflip else masks)
        sc = (out["refine_cls"] * out["refine_iou"])[..., 1:].mean(dim=0)
        total = sc if total is None else total + sc
    return total / float(len(passes))


def nms(dets: np.ndarray, thresh: float) -> list:
    """Greedy NMS of (n, 5) float32 [x1, y1, x2, y2, score]: descending
    score (ties by index), areas with the +1 convention, suppression at
    overlap >= thresh; returns the kept indices in order."""
    if len(dets) == 0:
        return []
    x1, y1, x2, y2, s = (dets[:, i] for i in range(5))
    one = np.float32(1.0)
    areas = (x2 - x1 + one) * (y2 - y1 + one)
    order = np.argsort(-s, kind="stable")
    alive = np.ones(len(dets), bool)
    keep = []
    for i in order:
        if not alive[i]:
            continue
        keep.append(int(i))
        alive[i] = False
        ww = np.maximum(np.float32(0.0), np.minimum(x2[i], x2) - np.maximum(x1[i], x1) + one)
        hh = np.maximum(np.float32(0.0), np.minimum(y2[i], y2) - np.maximum(y1[i], y1) + one)
        inter = ww * hh
        ovr = inter / (areas[i] + areas - inter)
        alive &= ~(ovr >= np.float32(thresh))
    return keep


def detections(scores: np.ndarray, boxes: np.ndarray, test: dict) -> list:
    """Per class: score threshold, greedy NMS, then the image's top
    DETECTIONS_PER_IM over all classes. Returns [(n_j, 5) float32] for the
    C classes in order."""
    c = scores.shape[1]
    out = []
    for j in range(c):
        inds = np.where(scores[:, j] > test["SCORE_THRESH"])[0]
        dets = np.hstack([boxes[inds], scores[inds, j][:, None]]).astype(np.float32)
        out.append(dets[nms(dets, test["NMS"])])
    limit = test["DETECTIONS_PER_IM"]
    if limit > 0:
        all_scores = np.hstack([d[:, -1] for d in out])
        if len(all_scores) > limit:
            thresh = np.sort(all_scores)[-limit]
            out = [d[d[:, -1] >= thresh] for d in out]
    return out
