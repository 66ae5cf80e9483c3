"""Inference engine: multi-scale / flip / aspect-ratio TTA (port of
cim_tpu/engine/test.py).

Behaviour contracts (reference lib/core/test.py): a pass resizes the image
by scale = target / max_side, scales the rois, runs the model and averages
the K refinement scores (cls * iou)[:, 1:]; im_detect_bbox_aug runs hflip,
then each scale with its hflip, then each aspect ratio with its hflip,
then identity, and combines the passes' scores by TEST.BBOX_AUG.SCORE_HEUR
(ID: the identity pass; AVG: the mean; UNION: the passes' rows stacked,
(M * N, C)) and the boxes by COORD_HEUR (ID, or UNION: (M * N, 4)). An
hflip pass flips the image, the boxes (W - x2 - 1) and the 7x7 masks.

Two paths, as in cim_tpu. The fused path (TPU.FUSED_TTA, scales x hflip
with AVG/ID): the original uint8 image is padded to a 128-multiple bucket
and moved to the device once, every pass resizes it there
(ops.image.resize_bilinear_dynamic, with the hflip folded in) onto a
canvas of 64-multiples sized by the image's aspect bucket. The per-pass
path (every other protocol): each pass is resized on the host (cv2, as
the reference) and uploaded as uint8 RGB, normalized on the device with
its pad masked to zero. Images pad to 128-multiple buckets and proposals
to a multiple of 256 with a validity mask; padded scores equal unpadded
ones. Evaluator runs one image at a time; BatchedEvaluator stacks the
images that share a bucket and runs every pass of the stack as one
forward (fused), or stacks single passes of a window of images (per-pass;
cim_tpu's vmap, written out as a batch axis), split over TPU.EVAL_DEVICES
cards. TPU.EVAL_INT8 runs MaskFuse's conv and first FC as dynamic int8
products (models.builder.int8_eval_view).
"""
from __future__ import annotations

import copy
import math

import numpy as np
import torch

from cim_tpu_torch.data.transforms import (
    TORCH_MEAN,
    TORCH_STD,
    aspect_ratio_rel,
    prep_image,
    prep_image_uint8_rgb,
    scale_for_target,
)
from cim_tpu_torch.models.builder import int8_eval_view
from cim_tpu_torch.ops.boxes import aspect_ratio, box_voting_np, flip_boxes
from cim_tpu_torch.ops.image import resize_bilinear_dynamic, resize_bilinear_dynamic_batched
from cim_tpu_torch.ops.nms import nms_np, soft_nms_np
from cim_tpu_torch.utils.device import check_on, resolve_device
from cim_tpu_torch.utils.trace import span

PAD_MULTIPLE = 128


def _round_up(x: int, m: int) -> int:
    return int(math.ceil(x / m) * m)


def _to_device(arrays, device):
    """Each host array as a tensor on ``device``. A copy from pageable
    memory waits for the card's queue: one cim.sync span each."""
    out = []
    for a in arrays:
        t = torch.from_numpy(a)
        with span("cim.sync"):
            out.append(t.to(device))
    return out


def _to_host(scores):
    """The scores on the host, as numpy (the wait for the card)."""
    with span("cim.sync"):
        return scores.cpu().numpy()


def _pass_canvas(target: int, ratio_hw):
    """A pass's canvas: (ceil(target * rh), ceil(target * rw)) rounded up
    to 64, which always holds the resized content round(src * target /
    max_side)."""
    rh, rw = ratio_hw
    return (_round_up(int(np.ceil(target * rh)), PAD_MULTIPLE // 2),
            _round_up(int(np.ceil(target * rw)), PAD_MULTIPLE // 2))


class Evaluator:
    """Runs the TTA protocol of cfg.TEST.BBOX_AUG for one image at a time
    with a CIMModel on ``device``: the card unless the caller passes
    device="cpu". The model must already lie on that device."""

    # short/long-side canvas ratio buckets (bucketed up; 1.0 = square)
    RATIO_BUCKETS = (0.5, 0.625, 0.75, 0.875, 1.0)

    def __init__(self, cfg, model, device="cuda"):
        """With TPU.EVAL_INT8 the evaluator runs an int8 view of ``model``
        that shares its parameters; ``model`` itself is left in float."""
        self.cfg = cfg
        self.device = resolve_device(device)
        check_on(model, self.device, "Evaluator")
        self.model = model.eval()
        if bool(cfg.TPU.get("EVAL_INT8", False)):
            self.model = int8_eval_view(self.model)
        # made once: a tensor built from host data on the card is a copy
        # from pageable memory, which waits for the card's queue
        self._pixel_means = torch.as_tensor(np.asarray(cfg.PIXEL_MEANS, np.float32),
                                            device=self.device)
        self._mean = torch.as_tensor(TORCH_MEAN, device=self.device)
        self._std = torch.as_tensor(TORCH_STD, device=self.device)

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
        AVG/ID heuristics. Aspect-ratio TTA (two chained resamplings) and
        the other heuristics take the per-pass path."""
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
        max_side = np.float32(max(im_h, im_w))
        masks_f = torch.flip(masks, [2])
        base = self._base_image(image_u8)

        passes = self.tta_pass_list(cfg)
        total = None
        with span("cim.eval.passes"):
            for target, hflip in passes:
                s = np.float32(target) / max_side
                img, (ovh, ovw) = resize_bilinear_dynamic(
                    base, _pass_canvas(target, ratio_hw), s, (im_h, im_w), hflip=hflip
                )
                if cfg.transform_mode == "ToTensor":
                    img = self._normalize(img)
                    img[ovh:] = 0.0
                    img[:, ovw:] = 0.0
                if hflip:
                    # flip about the original width, then scale
                    r = flip_boxes(rois, im_w) * float(s)
                    m = masks_f
                else:
                    r = rois * float(s)
                    m = masks
                sc = self._scores(self.model(img, r, m, valid, im_hw=(ovh, ovw)))
                total = sc if total is None else total + sc
        return total / float(len(passes))

    def _base_image(self, image_u8):
        """The float32 image (or stack) the passes resize: BGR minus the
        pixel means (blob.py:101-103, "org"), or RGB."""
        if self.cfg.transform_mode == "org":
            return image_u8.float() - self._pixel_means
        return image_u8.flip(-1).float()  # BGR -> RGB

    def _normalize(self, img):
        """blob.py:127-139: uint8 truncation, /255, normalize (ToTensor)."""
        return (torch.floor(img.clamp(0.0, 255.0)) / 255.0 - self._mean) / self._std

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
        with span("cim.eval.prepare"):
            req = self._prepare_raw(im, boxes, masks)
        with span("cim.upload"):
            inputs = _to_device([req[k] for k in ("image", "rois", "masks", "valid")],
                                self.device)
        scores = self._fused_forward(*inputs, req["im_h"], req["im_w"],
                                     ratio_hw=req["ratio_hw"])
        return _to_host(scores)[: req["n"]], boxes

    # ------------------------------------------------------ per-pass path

    def _scores(self, out):
        """The K-branch mean of (refine_cls * refine_iou)[..., 1:]."""
        return (out["refine_cls"] * out["refine_iou"])[..., 1:].mean(dim=-3)

    @torch.no_grad()
    def _forward(self, image, rois, masks, valid, im_h: int, im_w: int):
        """One pass of one image (cim_tpu Evaluator._forward): image (Hp,
        Wp, 3) on the device, uint8 RGB normalized here with its pad beyond
        (im_h, im_w) zeroed, or float32 as the host prepared it. Returns
        the (N, C) scores on the device."""
        if image.dtype == torch.uint8:
            image = self._normalize(image.float())
            image[im_h:] = 0.0
            image[:, im_w:] = 0.0
        return self._scores(self.model(image, rois, masks, valid, im_hw=(im_h, im_w)))

    def _prepare(self, im, boxes, masks, target_scale, target_max_size):
        """Host half of one pass: resize, scale the rois, pad to the shape
        bucket (cim_tpu Evaluator._prepare). Returns a request for
        _forward, or for a stack of them (BatchedEvaluator)."""
        cfg = self.cfg
        im_scale = scale_for_target(im.shape[:2], target_scale, target_max_size)
        if cfg.transform_mode == "ToTensor":
            # resized on the host as uint8 (cheap), normalized on the device
            im_prep = prep_image_uint8_rgb(im, im_scale)
        else:
            im_prep = prep_image(im, im_scale, cfg.transform_mode, cfg.PIXEL_MEANS)
        rois = boxes.astype(np.float32) * im_scale
        im_p, rois_p, masks_p, valid = self._pad_to_bucket(im_prep, rois, masks)
        return {
            "image": im_p,
            "rois": rois_p,
            "masks": masks_p,
            "valid": valid,
            "im_h": im_prep.shape[0],
            "im_w": im_prep.shape[1],
            "n": boxes.shape[0],
        }

    def im_detect_bbox(self, im, boxes, masks, target_scale, target_max_size):
        """One pass at one scale. im: (H, W, 3) uint8 BGR. Returns (scores
        (N, C), boxes)."""
        with span("cim.eval.prepare"):
            req = self._prepare(im, boxes, masks, target_scale, target_max_size)
        with span("cim.upload"):
            inputs = _to_device([req[k] for k in ("image", "rois", "masks", "valid")],
                                self.device)
        scores = self._forward(*inputs, req["im_h"], req["im_w"])
        return _to_host(scores)[: req["n"]], boxes

    @staticmethod
    def _hflip(im, boxes, masks):
        """The image, boxes (about the image's width) and 7x7 masks of an
        hflip pass."""
        boxes_f = flip_boxes(torch.from_numpy(np.asarray(boxes, np.float32)), im.shape[1])
        return im[:, ::-1, :], boxes_f.numpy(), np.flip(masks, 2).copy()

    @staticmethod
    def _aspect_ratio(im, boxes, ratio):
        """The image and boxes of an aspect-ratio pass (width scaled)."""
        boxes_ar = aspect_ratio(torch.from_numpy(np.asarray(boxes, np.float32)), ratio)
        return aspect_ratio_rel(im, ratio), boxes_ar.numpy()

    def im_detect_bbox_hflip(self, im, boxes, masks, target_scale, target_max_size):
        """The hflip pass; the scores map back to the original boxes (ID)."""
        scores, _ = self.im_detect_bbox(*self._hflip(im, boxes, masks), target_scale,
                                        target_max_size)
        return scores, boxes

    def im_detect_bbox_aspect_ratio(self, im, boxes, masks, ratio, hflip=False):
        """Width-relative aspect-ratio pass (reference
        im_detect_bbox_aspect_ratio, test.py:284-317)."""
        im_ar, boxes_ar = self._aspect_ratio(im, boxes, ratio)
        detect = self.im_detect_bbox_hflip if hflip else self.im_detect_bbox
        scores, _ = detect(im_ar, boxes_ar, masks, self.cfg.TEST.SCALE, self.cfg.TEST.MAX_SIZE)
        return scores, boxes

    def im_detect_all(self, im, boxes, masks):
        """Full TTA per cfg.TEST.BBOX_AUG (reference im_detect_bbox_aug).
        im: (H, W, 3) uint8 BGR; boxes (N, 4); masks (N, 7, 7). Returns
        (scores, boxes): (N, C) and the boxes, or (M * N, C) and (M * N,
        4) for UNION over M passes."""
        cfg = self.cfg
        if cfg.TPU.FUSED_TTA and self.fused_supported():
            return self.im_detect_all_fused(im, boxes, masks)
        if not cfg.TEST.BBOX_AUG.ENABLED:  # one pass, whatever the heuristics
            return self.im_detect_bbox(im, boxes, masks, cfg.TEST.SCALE, cfg.TEST.MAX_SIZE)
        scores_ts = [self.im_detect_bbox(*inputs)[0]
                     for inputs in self.iter_tta_inputs(im, boxes, masks)]
        return combine_passes(cfg, scores_ts, boxes)

    def iter_tta_inputs(self, im, boxes, masks):
        """(image, boxes, masks, scale, max_size) of every TTA pass of
        cfg.TEST.BBOX_AUG, in im_detect_all's order. Each pass's scores
        align 1:1 with the original proposals (hflip and aspect ratio
        transform the inputs), so AVG is a plain mean over passes."""
        cfg = self.cfg
        aug = cfg.TEST.BBOX_AUG
        if not aug.ENABLED:
            yield (im, boxes, masks, cfg.TEST.SCALE, cfg.TEST.MAX_SIZE)
            return
        if aug.H_FLIP:
            yield (*self._hflip(im, boxes, masks), cfg.TEST.SCALE, cfg.TEST.MAX_SIZE)
        for scale in aug.SCALES:
            yield (im, boxes, masks, scale, aug.MAX_SIZE)
            if aug.SCALE_H_FLIP:
                yield (*self._hflip(im, boxes, masks), scale, aug.MAX_SIZE)
        for ratio in aug.ASPECT_RATIOS:
            im_ar, boxes_ar = self._aspect_ratio(im, boxes, ratio)
            yield (im_ar, boxes_ar, masks, cfg.TEST.SCALE, cfg.TEST.MAX_SIZE)
            if aug.ASPECT_RATIO_H_FLIP:
                yield (*self._hflip(im_ar, boxes_ar, masks), cfg.TEST.SCALE, cfg.TEST.MAX_SIZE)
        yield (im, boxes, masks, cfg.TEST.SCALE, cfg.TEST.MAX_SIZE)


def combine_passes(cfg, scores_ts, boxes):
    """The passes' (N, C) scores, identity last, combined by
    TEST.BBOX_AUG.SCORE_HEUR and the boxes by COORD_HEUR (cim_tpu
    im_detect_all, :372-388); another heuristic raises, as there."""
    aug = cfg.TEST.BBOX_AUG
    if aug.SCORE_HEUR == "ID":
        scores = scores_ts[-1]
    elif aug.SCORE_HEUR == "AVG":
        scores = np.mean(scores_ts, axis=0)
    elif aug.SCORE_HEUR == "UNION":
        scores = np.vstack(scores_ts)
    else:
        raise NotImplementedError(f"Score heur {aug.SCORE_HEUR} not supported")
    if aug.COORD_HEUR == "ID":
        boxes_c = boxes
    elif aug.COORD_HEUR == "UNION":
        boxes_c = np.vstack([boxes] * len(scores_ts))
    else:
        raise NotImplementedError(f"Coord heur {aug.COORD_HEUR} not supported")
    return scores, boxes_c


class BatchedEvaluator(Evaluator):
    """Cross-image batched TTA (port of cim_tpu/engine/test.py:428-579).
    Fused path: whole images are grouped by (original-image bucket,
    proposal pad, canvas-ratio bucket), and each stack of ``batch_size``
    runs every TTA pass as one forward of the stack, so a pass launches
    its kernels once for B images. Per-pass path (FUSED_TTA off, or aspect
    ratios, with AVG/ID): the host-prepared passes of a window of images
    are grouped by (pass bucket, proposal pad), each stack of
    ``batch_size`` passes is one forward, and each image's scores are the
    mean of its passes'. The scores are each image's own, as Evaluator
    gives them, to float32 rounding (batched products may sum in another
    order). Other heuristics (UNION) fall back to Evaluator per image.

    Unlike cim_tpu, which pads a partial stack to batch_size by repeating
    its last member (jit needs one shape), a partial stack runs at its
    real size: eager PyTorch has no fixed shape to meet, and a repeated
    member changes no other member's scores.

    devices: the cards a stack is split over (cim_tpu's mesh over
    TPU.EVAL_DEVICES, the reference's DataParallel test model). The model
    lies on the first; each other device holds a copy with the same
    weights (a device named twice shares the model). Each stack splits
    into contiguous sub-stacks, one a device, dispatched in turn, so the
    cards run them at once; batch_size rounds up to a multiple of the
    device count, as cim_tpu's does. One device is the single-card path.
    """

    def __init__(self, cfg, model, batch_size: int | None = None, device="cuda",
                 devices=None):
        devices = [torch.device(d) for d in devices] if devices else [resolve_device(device)]
        super().__init__(cfg, model, device=devices[0])
        n = len(devices)
        self.batch_size = -(-int(batch_size or cfg.TPU.EVAL_BATCH) // n) * n
        # the evaluator of each sub-stack: this one, then one a device
        self._replicas = [self] + [
            BatchedEvaluator(cfg, model if d == devices[0] else copy.deepcopy(model).to(d),
                             self.batch_size, device=d)
            for d in devices[1:]]

    def _batched_supported(self) -> bool:
        aug = self.cfg.TEST.BBOX_AUG
        return (not aug.ENABLED) or (aug.SCORE_HEUR == "AVG" and aug.COORD_HEUR == "ID")

    @torch.no_grad()
    def _fused_forward_batched(self, images_u8, rois, masks, valid, im_hws,
                               ratio_hw=(1.0, 1.0)):
        """All TTA passes of a stack of B images that share a bucket;
        returns the (B, N, C) pass-averaged scores on the device.

        images_u8 (B, Hp, Wp, 3) uint8 BGR, rois (B, N, 4), masks (B, N, 7,
        7), valid (B, N), im_hws the B (im_h, im_w). Each image keeps its
        own scale, flip width and content extent, as under cim_tpu's vmap;
        the canvas of a pass is the stack's (one ratio bucket).
        """
        cfg = self.cfg
        dev = images_u8.device
        max_side = np.array([max(h, w) for h, w in im_hws], np.float32)
        passes = self.tta_pass_list(cfg)
        # float32 scales of every (pass, image), computed as Evaluator does
        scales = np.array([t for t, _ in passes], np.float32)[:, None] / max_side[None, :]
        # one copy a stack: the scales and the widths that hflip flips about
        with span("cim.upload"):
            scales_t, widths = _to_device(
                [scales, np.array([[w] for _, w in im_hws], np.float32)], dev)
        masks_f = torch.flip(masks, [-1])
        base = self._base_image(images_u8)

        total = None
        with span("cim.eval.passes"):
            for p, (target, hflip) in enumerate(passes):
                img, extents = resize_bilinear_dynamic_batched(
                    base, _pass_canvas(target, ratio_hw), scales[p], im_hws, hflip=hflip
                )
                if cfg.transform_mode == "ToTensor":
                    img = self._normalize(img)
                    for one, (ovh, ovw) in zip(img, extents):
                        one[ovh:] = 0.0
                        one[:, ovw:] = 0.0
                s = scales_t[p][:, None, None]
                r = (flip_boxes(rois, widths) if hflip else rois) * s
                sc = self._scores(self.model(img, r, masks_f if hflip else masks, valid,
                                             im_hw=extents))
                total = sc if total is None else total + sc
        return total / float(len(passes))

    @torch.no_grad()
    def _forward_batched(self, images, rois, masks, valid, im_hws):
        """One pass of each member of a stack (cim_tpu's vmap over
        _forward): images (B, Hp, Wp, 3), uint8 RGB normalized here with
        each member's pad beyond its (im_h, im_w) zeroed, or float32;
        returns the (B, N, C) scores on the device."""
        with span("cim.eval.passes"):
            if images.dtype == torch.uint8:
                images = self._normalize(images.float())
                for one, (h, w) in zip(images, im_hws):
                    one[h:] = 0.0
                    one[:, w:] = 0.0
            return self._scores(self.model(images, rois, masks, valid, im_hw=list(im_hws)))

    def _dispatch(self, group):
        """Queue a stack on this evaluator's device: every pass of whole
        images (fused requests, which carry a ratio bucket), or one pass of
        each member (per-pass requests); returns the scores on the
        device."""
        reqs = [r for _, r in group]
        with span("cim.upload"):
            stacked = _to_device([np.stack([r[k] for r in reqs])
                                  for k in ("image", "rois", "masks", "valid")], self.device)
        im_hws = [(r["im_h"], r["im_w"]) for r in reqs]
        if "ratio_hw" in reqs[0]:
            return self._fused_forward_batched(*stacked, im_hws, reqs[0]["ratio_hw"])
        return self._forward_batched(*stacked, im_hws)

    def _run_stack(self, group):
        """group: [(item index, request)] of one key -> [(index, scores)].
        Contiguous sub-stacks of near-equal size, one a device, all
        dispatched before the first is read."""
        size = -(-len(group) // len(self._replicas))
        parts = [group[i: i + size] for i in range(0, len(group), size)]
        queued = [(part, rep._dispatch(part)) for part, rep in zip(parts, self._replicas)]
        out = []
        for part, scores in queued:
            scores = _to_host(scores)
            out += [(idx, scores[i][: req["n"]]) for i, (idx, req) in enumerate(part)]
        return out

    def _fused_batched_many(self, items):
        out = [None] * len(items)
        groups: dict = {}
        for idx, (im, boxes, masks) in enumerate(items):
            with span("cim.eval.prepare"):
                req = self._prepare_raw(im, boxes, masks)
                key = (req["image"].shape, req["rois"].shape[0], req["ratio_hw"])
                groups.setdefault(key, []).append((idx, req))
            if len(groups[key]) == self.batch_size:
                for i, scores in self._run_stack(groups.pop(key)):
                    out[i] = scores
        for group in groups.values():  # partial stacks, at their own size
            for i, scores in self._run_stack(group):
                out[i] = scores
        return [(out[i], items[i][1]) for i in range(len(items))]

    def im_detect_all_many(self, items, window: int | None = None):
        """items: list of (im, boxes, masks). Returns [(scores, boxes)] in
        order. On the per-pass path the passes of up to ``window`` images
        (4 x batch_size by default) are stacked together."""
        if not self._batched_supported():
            return [self.im_detect_all(im, b, m) for im, b, m in items]
        if self.cfg.TPU.FUSED_TTA and self.fused_supported():
            return self._fused_batched_many(items)
        window = window or 4 * self.batch_size
        out_sum = [None] * len(items)
        out_cnt = [0] * len(items)
        for w0 in range(0, len(items), window):
            groups: dict = {}
            for idx, (im, boxes, masks) in enumerate(items[w0: w0 + window], start=w0):
                full = []  # the stacks this image's passes fill, run once it is prepared
                with span("cim.eval.prepare"):
                    for im_x, b_x, m_x, scale, max_size in self.iter_tta_inputs(im, boxes,
                                                                                masks):
                        req = self._prepare(im_x, b_x, m_x, scale, max_size)
                        key = (req["image"].shape, req["rois"].shape[0])
                        groups.setdefault(key, []).append((idx, req))
                        if len(groups[key]) == self.batch_size:
                            full.append(groups.pop(key))
                for group in full:
                    self._scatter(self._run_stack(group), out_sum, out_cnt)
            for group in groups.values():  # partial stacks, at their own size
                self._scatter(self._run_stack(group), out_sum, out_cnt)
        return [(out_sum[i] / out_cnt[i], items[i][1]) for i in range(len(items))]

    @staticmethod
    def _scatter(scored, out_sum, out_cnt):
        """Add each pass's scores to its image's sum."""
        for idx, s in scored:
            out_sum[idx] = s if out_sum[idx] is None else out_sum[idx] + s
            out_cnt[idx] += 1


def box_results_with_nms_and_limit(cfg, scores, boxes):
    """Score threshold + per-class NMS + top-K over all classes
    (reference lib/core/test.py:355-423). scores: (N, C) without bg;
    boxes: (N, 4). Returns (scores, boxes, cls_boxes) where cls_boxes[j]
    for j in 1..C holds the (n_j, 5) detections of class j - 1."""
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
        # post-NMS box voting (reference test.py:390-396; off by default)
        if cfg.TEST.BBOX_VOTE.ENABLED and len(nms_dets):
            nms_dets = box_voting_np(
                nms_dets, dets_j, cfg.TEST.BBOX_VOTE.VOTE_TH,
                scoring_method=cfg.TEST.BBOX_VOTE.SCORING_METHOD,
            )
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
