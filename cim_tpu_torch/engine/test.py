"""Inference engine: fused 10-pass flip+scale TTA (port of cim_tpu/engine/test.py).

Behaviour contracts (reference lib/core/test.py): a pass resizes the image
by scale = target / max_side, scales the rois, runs the model and averages
the K refinement scores (cls * iou)[:, 1:]; im_detect_bbox_aug runs hflip,
then each scale with its hflip, then identity, and averages the scores
over the passes (AVG heuristic, boxes by ID). An hflip pass flips the
image, the boxes (W - x2 - 1) and the 7x7 masks.

Ported here is cim_tpu's fused single-image path: the original uint8
image is padded to a 128-multiple bucket and moved to the device once,
every pass resizes it there (ops.image.resize_bilinear_dynamic, with the
hflip folded in) onto a canvas of 64-multiples sized by the image's aspect
bucket, and proposals pad to a multiple of 256 with a validity mask. The
per-pass host path (which needs cv2) and the cross-image BatchedEvaluator
are not ported yet.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from cim_tpu_torch.data.transforms import TORCH_MEAN, TORCH_STD
from cim_tpu_torch.ops.boxes import flip_boxes
from cim_tpu_torch.ops.image import resize_bilinear_dynamic
from cim_tpu_torch.ops.nms import nms_np, soft_nms_np
from cim_tpu_torch.utils.device import check_on, resolve_device

PAD_MULTIPLE = 128


def _round_up(x: int, m: int) -> int:
    return int(math.ceil(x / m) * m)


class Evaluator:
    """Runs the TTA protocol of cfg.TEST.BBOX_AUG for one image at a time
    with a CIMModel on ``device``: the card unless the caller passes
    device="cpu". The model must already lie on that device."""

    # short/long-side canvas ratio buckets (bucketed up; 1.0 = square)
    RATIO_BUCKETS = (0.5, 0.625, 0.75, 0.875, 1.0)

    def __init__(self, cfg, model, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        check_on(model, self.device, "Evaluator")
        self.model = model.eval()

    @staticmethod
    def tta_pass_list(cfg):
        """(target_scale, hflip) of every pass, in im_detect_all's order."""
        if not cfg.TEST.BBOX_AUG.ENABLED:
            return [(int(cfg.TEST.SCALE), False)]
        passes = []
        if cfg.TEST.BBOX_AUG.H_FLIP:
            passes.append((int(cfg.TEST.SCALE), True))
        for s in cfg.TEST.BBOX_AUG.SCALES:
            passes.append((int(s), False))
            if cfg.TEST.BBOX_AUG.SCALE_H_FLIP:
                passes.append((int(s), True))
        passes.append((int(cfg.TEST.SCALE), False))
        return passes

    def fused_supported(self) -> bool:
        """Fused TTA covers the shipped protocols: scales x hflip with the
        AVG/ID heuristics. Aspect-ratio TTA and UNION are not fused."""
        cfg = self.cfg
        aug = cfg.TEST.BBOX_AUG
        if cfg.transform_mode not in ("ToTensor", "org"):
            return False
        if not aug.ENABLED:
            return True
        return bool(
            aug.SCORE_HEUR == "AVG"
            and aug.COORD_HEUR == "ID"
            and not tuple(aug.ASPECT_RATIOS)
        )

    @torch.no_grad()
    def _fused_forward(self, image_u8, rois, masks, valid, im_h: int, im_w: int,
                       ratio_hw=(1.0, 1.0)):
        """All TTA passes of one image; returns the (N, C) pass-averaged
        scores on the device.

        image_u8: the padded uint8 BGR bucket on the device. ratio_hw: the
        per-side upper bound on (im_h, im_w) / max_side; a pass's canvas is
        (ceil(target * rh), ceil(target * rw)) rounded up to 64, which always
        holds the resized content round(src * target / max_side).
        """
        cfg = self.cfg
        dev = image_u8.device
        max_side = np.float32(max(im_h, im_w))
        masks_f = torch.flip(masks, [2])
        if cfg.transform_mode == "org":
            # blob.py:101-103: float32 BGR minus means, then resize
            means = torch.as_tensor(np.asarray(cfg.PIXEL_MEANS, np.float32).reshape(1, 1, 3),
                                    device=dev)
            base = image_u8.float() - means
        else:
            base = image_u8.flip(-1).float()  # BGR -> RGB
        mean = torch.as_tensor(TORCH_MEAN, device=dev)
        std = torch.as_tensor(TORCH_STD, device=dev)

        rh, rw = ratio_hw
        passes = self.tta_pass_list(cfg)
        total = None
        for target, hflip in passes:
            ch = _round_up(int(np.ceil(target * rh)), PAD_MULTIPLE // 2)
            cw = _round_up(int(np.ceil(target * rw)), PAD_MULTIPLE // 2)
            s = np.float32(target) / max_side
            img, (ovh, ovw) = resize_bilinear_dynamic(
                base, (ch, cw), s, (im_h, im_w), hflip=hflip
            )
            if cfg.transform_mode == "ToTensor":
                # blob.py:127-139: uint8 truncation, /255, normalize
                img = torch.floor(img.clamp(0.0, 255.0)) / 255.0
                img = (img - mean) / std
                img[ovh:] = 0.0
                img[:, ovw:] = 0.0
            if hflip:
                # flip about the original width, then scale
                r = flip_boxes(rois, im_w) * float(s)
                m = masks_f
            else:
                r = rois * float(s)
                m = masks
            out = self.model(img, r, m, valid, im_hw=(ovh, ovw))
            sc = (out["refine_cls"] * out["refine_iou"])[:, :, 1:].mean(dim=0)
            total = sc if total is None else total + sc
        return total / float(len(passes))

    @staticmethod
    def _ratio_bucket(h, w):
        long = float(max(h, w))
        buckets = Evaluator.RATIO_BUCKETS
        rh = next(b for b in buckets if b >= h / long - 1e-9)
        rw = next(b for b in buckets if b >= w / long - 1e-9)
        return (rh, rw)

    @staticmethod
    def _pad_to_bucket(im, boxes, masks):
        n = boxes.shape[0]
        n_pad = max(256, _round_up(n, 256))
        h, w = im.shape[:2]
        hp, wp = _round_up(h, PAD_MULTIPLE), _round_up(w, PAD_MULTIPLE)
        im_p = np.zeros((hp, wp, 3), im.dtype)
        im_p[:h, :w] = im
        boxes_p = np.zeros((n_pad, 4), np.float32)
        boxes_p[:n] = boxes
        masks_p = np.zeros((n_pad,) + masks.shape[1:], np.float32)
        masks_p[:n] = masks
        valid = np.zeros(n_pad, bool)
        valid[:n] = True
        return im_p, boxes_p, masks_p, valid

    def _prepare_raw(self, im, boxes, masks):
        """Pad the original image and proposals to their buckets (the
        passes resize on the device)."""
        im_p, rois_p, masks_p, valid = self._pad_to_bucket(im, boxes, masks)
        return {
            "image": im_p,
            "rois": rois_p,
            "masks": masks_p,
            "valid": valid,
            "im_h": im.shape[0],
            "im_w": im.shape[1],
            "ratio_hw": self._ratio_bucket(im.shape[0], im.shape[1]),
            "n": boxes.shape[0],
        }

    def im_detect_all_fused(self, im, boxes, masks):
        req = self._prepare_raw(im, boxes, masks)
        dev = self.device
        scores = self._fused_forward(
            torch.from_numpy(req["image"]).to(dev),
            torch.from_numpy(req["rois"]).to(dev),
            torch.from_numpy(req["masks"]).to(dev),
            torch.from_numpy(req["valid"]).to(dev),
            req["im_h"], req["im_w"], ratio_hw=req["ratio_hw"],
        )
        return scores.cpu().numpy()[: req["n"]], boxes

    def im_detect_all(self, im, boxes, masks):
        """Full TTA per cfg.TEST.BBOX_AUG (reference im_detect_bbox_aug).
        im: (H, W, 3) uint8 BGR; boxes (N, 4); masks (N, 7, 7).
        Returns (scores (N, C), boxes)."""
        if not (self.cfg.TPU.FUSED_TTA and self.fused_supported()):
            raise NotImplementedError(
                "only the fused TTA path is ported (TPU.FUSED_TTA with the "
                "AVG/ID heuristics, no aspect-ratio passes)"
            )
        return self.im_detect_all_fused(im, boxes, masks)


def box_results_with_nms_and_limit(cfg, scores, boxes):
    """Score threshold + per-class NMS + top-K over all classes
    (reference lib/core/test.py:355-423). scores: (N, C) without bg;
    boxes: (N, 4). Returns (scores, boxes, cls_boxes) where cls_boxes[j]
    for j in 1..C holds the (n_j, 5) detections of class j - 1."""
    if cfg.TEST.BBOX_VOTE.ENABLED:
        raise NotImplementedError("TEST.BBOX_VOTE is not ported yet")
    num_classes = cfg.MODEL.NUM_CLASSES
    cls_boxes = [np.zeros((0, 5), np.float32) for _ in range(num_classes)]
    for j in range(num_classes):
        inds = np.where(scores[:, j] > cfg.TEST.SCORE_THRESH)[0]
        dets_j = np.hstack([boxes[inds], scores[inds, j][:, None]]).astype(np.float32)
        if cfg.TEST.SOFT_NMS.ENABLED:
            nms_dets, _ = soft_nms_np(
                dets_j,
                sigma=cfg.TEST.SOFT_NMS.SIGMA,
                overlap_thresh=cfg.TEST.NMS,
                score_thresh=0.0001,
                method=cfg.TEST.SOFT_NMS.METHOD,
            )
        else:
            nms_dets = dets_j[nms_np(dets_j, cfg.TEST.NMS)]
        cls_boxes[j] = nms_dets

    if cfg.TEST.DETECTIONS_PER_IM > 0:
        image_scores = np.hstack([cls_boxes[j][:, -1] for j in range(num_classes)])
        if len(image_scores) > cfg.TEST.DETECTIONS_PER_IM:
            image_thresh = np.sort(image_scores)[-cfg.TEST.DETECTIONS_PER_IM]
            for j in range(num_classes):
                keep = np.where(cls_boxes[j][:, -1] >= image_thresh)[0]
                cls_boxes[j] = cls_boxes[j][keep]

    # 1-indexed class list with an empty background slot (reference test.py:410-415)
    out = [np.zeros((0, 5), np.float32)] + cls_boxes
    im_results = np.vstack([out[j] for j in range(1, num_classes)])
    return im_results[:, -1], im_results[:, :-1], out


def box_results_for_corloc(cfg, scores, boxes):
    """Argmax box per class (CorLoc protocol, reference test.py:320-352)."""
    num_classes = cfg.MODEL.NUM_CLASSES
    cls_boxes = []
    for j in range(num_classes):
        max_ind = int(np.argmax(scores[:, j]))
        cls_boxes.append(
            np.hstack([boxes[max_ind][None, :], [[scores[max_ind, j]]]]).astype(np.float32)
        )
    out = [np.zeros((0, 5), np.float32)] + cls_boxes
    im_results = np.vstack([out[j] for j in range(1, num_classes)])
    return im_results[:, -1], im_results[:, :-1], out
