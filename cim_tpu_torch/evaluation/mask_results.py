"""Mask result post-processing: per-class threshold and NMS, then top-K
over classes, keeping proposal *indices* so that the original
full-resolution COB mask can be fetched (port of
cim_tpu/evaluation/mask_results.py).

Behaviour contract: reference lib/utils/mask_eval_utils.py:6-110
(mask_results_with_nms_and_limit[_get_index]) and coco_encode (:112-117,
through the port's evaluation.rle instead of pycocotools). NMS is the
port's ops.nms.nms_np (the C++ kernel of cim_tpu_torch.native, the same
source as cim_tpu's), so both packages keep the same proposals.
"""
from __future__ import annotations

import numpy as np

from cim_tpu_torch.evaluation import rle as rle_util
from cim_tpu_torch.ops.nms import nms_np


def mask_results_with_nms_and_limit_get_index(cfg, scores, boxes, detections_per_im: int = 100):
    """scores: (N, C) per-proposal class scores (no background); boxes: (N, 4).

    Returns (scores, boxes, cls_boxes, cls_inds): cls_boxes / cls_inds are
    1-indexed per-class lists (slot 0 empty); cls_inds[j] holds the kept
    *proposal indices* of class j - 1. As in the reference, the flat scores
    and boxes stack classes 1..C-1 only (range(1, num_classes), :50): the
    last class is left out of them.
    """
    num_classes = cfg.MODEL.NUM_CLASSES
    cls_boxes = [np.zeros((0, 5), np.float32) for _ in range(num_classes)]
    cls_inds = [np.zeros((0,), np.int64) for _ in range(num_classes)]
    all_idx = np.arange(len(scores))

    for j in range(num_classes):
        inds = np.where(scores[:, j] > cfg.TEST.SCORE_THRESH)[0]
        dets_j = np.hstack([boxes[inds], scores[inds, j][:, None]]).astype(np.float32)
        keep = nms_np(dets_j, cfg.TEST.NMS)
        cls_boxes[j] = dets_j[keep]
        cls_inds[j] = all_idx[inds][keep]

    if detections_per_im > 0:
        image_scores = np.hstack([cls_boxes[j][:, -1] for j in range(num_classes)])
        if len(image_scores) > detections_per_im:
            image_thresh = np.sort(image_scores)[-detections_per_im]
            for j in range(num_classes):
                keep = np.where(cls_boxes[j][:, -1] >= image_thresh)[0]
                cls_boxes[j] = cls_boxes[j][keep]
                cls_inds[j] = cls_inds[j][keep]

    out_boxes = [np.zeros((0, 5), np.float32)] + cls_boxes
    out_inds = [np.zeros((0,), np.int64)] + cls_inds
    im_results = np.vstack([out_boxes[j] for j in range(1, num_classes)])
    return im_results[:, -1], im_results[:, :-1], out_boxes, out_inds


def proposal_index(row: int, n_rows: int, n_proposals: int) -> int:
    """The proposal that detection row ``row`` of an image's ``n_rows``
    scores belongs to: the row itself, or, for a TEST.BBOX_AUG UNION
    record, which stacks M passes' rows over the same N proposals
    (engine.test.combine_passes), the row modulo N. (cim_tpu's exporter
    and evaluation index the proposals by the row and so fail on UNION
    records.)"""
    if n_rows % n_proposals:
        raise ValueError(f"{n_rows} score rows are no whole number of passes over "
                         f"{n_proposals} proposals")
    return int(row) % n_proposals


def mask_results_with_nms_and_limit(cfg, scores, boxes, masks):
    """The same, returning the kept masks instead of indices
    (reference mask_eval_utils.py:6-54)."""
    s, b, cls_boxes, cls_inds = mask_results_with_nms_and_limit_get_index(
        cfg, scores, boxes, cfg.TEST.DETECTIONS_PER_IM
    )
    cls_masks = [
        masks[idx] if len(idx) else np.zeros((0,) + masks.shape[1:], masks.dtype)
        for idx in cls_inds
    ]
    return s, b, cls_boxes, cls_masks


def coco_encode(mask: np.ndarray) -> dict:
    """Binary mask -> COCO compressed RLE with a str counts field
    (reference mask_eval_utils.py:112-117)."""
    return rle_util.encode(np.ascontiguousarray(mask).astype(np.uint8))
