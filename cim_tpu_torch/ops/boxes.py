"""Box geometry of the eval path (port of cim_tpu/ops/boxes.py): the flip
and aspect-ratio transforms of the TTA passes (torch, on any device), and
the host-side IoU and box voting of TEST.BBOX_VOTE in numpy."""
from __future__ import annotations

import numpy as np
import torch


def flip_boxes(boxes: torch.Tensor, im_width) -> torch.Tensor:
    """Horizontal flip of xyxy boxes (reference lib/utils/boxes.py
    flip_boxes): x1' = W - x2 - 1, x2' = W - x1 - 1."""
    x1 = im_width - boxes[..., 2] - 1
    x2 = im_width - boxes[..., 0] - 1
    return torch.stack([x1, boxes[..., 1], x2, boxes[..., 3]], dim=-1)


def aspect_ratio(boxes: torch.Tensor, ratio: float) -> torch.Tensor:
    """Scale the x coordinates of xyxy boxes by a width-relative aspect
    ratio (reference lib/utils/boxes.py aspect_ratio)."""
    return torch.stack([boxes[..., 0] * ratio, boxes[..., 1], boxes[..., 2] * ratio,
                        boxes[..., 3]], dim=-1)


def box_iou_np(boxes_a, boxes_b, legacy_plus_one: bool = False):
    """Pairwise IoU of (N, 4) and (K, 4) xyxy boxes -> (N, K), in the
    boxes' dtype. With ``legacy_plus_one`` areas count the end pixel, as
    the reference's cython bbox_overlaps does (lib/utils/cython_bbox.c)."""
    off = boxes_a.dtype.type(1.0 if legacy_plus_one else 0.0)

    def area(b):
        return (b[:, 2] - b[:, 0] + off) * (b[:, 3] - b[:, 1] + off)

    lt = np.maximum(boxes_a[:, None, :2], boxes_b[None, :, :2])
    rb = np.minimum(boxes_a[:, None, 2:], boxes_b[None, :, 2:])
    wh = np.clip(rb - lt + off, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area(boxes_a)[:, None] + area(boxes_b)[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / union, 0).astype(inter.dtype)


def box_voting_np(top_dets, all_dets, thresh, scoring_method="ID", beta=1.0):
    """Bounding-box voting (reference lib/utils/boxes.py box_voting,
    arXiv:1505.01749; post-NMS refinement under TEST.BBOX_VOTE): each kept
    box becomes the score-weighted mean of the boxes that overlap it by at
    least ``thresh``. top_dets / all_dets: (n, 5) numpy arrays."""
    top_boxes = top_dets[:, :4]
    all_boxes = all_dets[:, :4]
    all_scores = all_dets[:, 4]
    out = top_dets.copy()
    iou = box_iou_np(top_boxes, all_boxes, legacy_plus_one=True)
    for k in range(top_dets.shape[0]):
        inds = np.where(iou[k] >= thresh)[0]
        ws = all_scores[inds]
        out[k, :4] = np.average(all_boxes[inds], axis=0, weights=ws)
        if scoring_method == "ID":
            pass
        elif scoring_method == "TEMP_AVG":
            # temperature-smooth each (p, 1 - p) binary distribution, then
            # average the positive component (reference :288-299)
            p2 = np.vstack((ws, 1.0 - ws))
            x = np.log(p2 / p2.max(axis=0))
            x_exp = np.exp(x / beta)
            out[k, 4] = (x_exp / x_exp.sum(axis=0))[0].mean()
        elif scoring_method == "AVG":
            out[k, 4] = ws.mean()
        elif scoring_method == "IOU_AVG":
            out[k, 4] = np.average(ws, weights=iou[k, inds])
        elif scoring_method == "GENERALIZED_AVG":
            out[k, 4] = np.mean(ws ** beta) ** (1.0 / beta)
        elif scoring_method == "QUASI_SUM":
            out[k, 4] = ws.sum() / float(len(ws)) ** beta
        else:
            raise NotImplementedError(scoring_method)
    return out
