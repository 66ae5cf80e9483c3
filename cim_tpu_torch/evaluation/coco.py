"""Minimal COCO dataset API + COCOeval-protocol evaluator (numpy).

pycocotools is not available in the runtime image, so the framework ships
its own implementation of the pieces the reference uses:
- COCO json indexing (pycocotools.coco.COCO subset: getImgIds/getCatIds/
  getAnnIds/loadImgs/loadAnns/loadRes) — consumed by the data layer
  (reference lib/datasets/json_dataset.py) and evaluators;
- the COCOeval matching/accumulation protocol for 'bbox' and 'segm'
  (reference lib/datasets/json_dataset_evaluator.py:38-56 and
  lib/datasets/json_inference.py:24-56 use pycocotools.COCOeval).

The evaluation protocol follows the published COCO algorithm: greedy
score-ordered matching per (image, category) at each IoU threshold with
crowd/ignore handling, 101-point interpolated precision, area ranges and
maxDets — so numbers are comparable with standard tooling.
"""
from __future__ import annotations

import copy
import json
from collections import defaultdict

import numpy as np

from cim_tpu_torch.evaluation import rle as rle_util


class COCO:
    def __init__(self, annotation_file=None):
        self.dataset = {}
        self.anns = {}
        self.imgs = {}
        self.cats = {}
        self.img_to_anns = defaultdict(list)
        self.cat_to_imgs = defaultdict(list)
        if annotation_file is not None:
            if isinstance(annotation_file, str):
                with open(annotation_file) as f:
                    self.dataset = json.load(f)
            else:
                self.dataset = annotation_file
            self.create_index()

    # pycocotools-compatible aliases
    def createIndex(self):  # noqa: N802
        self.create_index()

    def create_index(self):
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.img_to_anns[ann["image_id"]].append(ann)
            self.cat_to_imgs[ann["category_id"]].append(ann["image_id"])

    def getImgIds(self, imgIds=None, catIds=None):  # noqa: N802
        ids = set(self.imgs.keys())
        if catIds:
            cat_imgs = set()
            for c in catIds:
                cat_imgs |= set(self.cat_to_imgs[c])
            ids &= cat_imgs
        if imgIds:
            ids &= set(imgIds)
        return sorted(ids)

    def getCatIds(self, catNms=None, supNms=None, catIds=None):  # noqa: N802
        cats = list(self.cats.values())
        if catNms:
            cats = [c for c in cats if c["name"] in catNms]
        if supNms:
            cats = [c for c in cats if c.get("supercategory") in supNms]
        if catIds:
            cats = [c for c in cats if c["id"] in catIds]
        return sorted(c["id"] for c in cats)

    def getAnnIds(self, imgIds=None, catIds=None, areaRng=None, iscrowd=None):  # noqa: N802
        anns = []
        if imgIds is not None:
            if not isinstance(imgIds, (list, tuple)):
                imgIds = [imgIds]
            for i in imgIds:
                anns.extend(self.img_to_anns[i])
        else:
            anns = list(self.anns.values())
        if catIds is not None:
            if not isinstance(catIds, (list, tuple)):
                catIds = [catIds]
            cat_set = set(catIds)
            anns = [a for a in anns if a["category_id"] in cat_set]
        if areaRng:
            anns = [a for a in anns if areaRng[0] < a["area"] < areaRng[1]]
        if iscrowd is not None:
            anns = [a for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns]

    def loadImgs(self, ids):  # noqa: N802
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def loadAnns(self, ids):  # noqa: N802
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.anns[i] for i in ids]

    def loadCats(self, ids):  # noqa: N802
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.cats[i] for i in ids]

    def annToRLE(self, ann):  # noqa: N802
        """Annotation segmentation -> compressed RLE. Polygon lists and
        uncompressed RLE dicts are rasterized/compressed with the
        pycocotools frPyObjects semantics (rle.fr_poly_objects); the
        reference relies on pycocotools for this
        (lib/datasets/json_inference.py:54)."""
        img = self.imgs[ann["image_id"]]
        h, w = img["height"], img["width"]
        return rle_util.fr_poly_objects(ann["segmentation"], h, w)

    def annToMask(self, ann):  # noqa: N802
        return rle_util.decode(self.annToRLE(ann))

    def loadRes(self, res):  # noqa: N802
        """Result json/list -> a COCO object holding the detections."""
        out = COCO()
        out.dataset["images"] = list(self.dataset.get("images", []))
        out.dataset["categories"] = copy.deepcopy(
            self.dataset.get("categories", [])
        )
        if isinstance(res, str):
            with open(res) as f:
                anns = json.load(f)
        else:
            anns = copy.deepcopy(res)
        for i, ann in enumerate(anns):
            ann["id"] = i + 1
            if "bbox" in ann and "area" not in ann:
                x, y, w, h = ann["bbox"]
                ann["area"] = w * h
            if "segmentation" in ann and "area" not in ann:
                ann["area"] = rle_util.area(ann["segmentation"])
            if "segmentation" in ann and "bbox" not in ann:
                ann["bbox"] = rle_util.to_bbox(ann["segmentation"]).tolist()
            ann.setdefault("iscrowd", 0)
        out.dataset["annotations"] = anns
        out.create_index()
        return out


class COCOeval:
    """COCO evaluation protocol for iouType in {'bbox', 'segm'}."""

    def __init__(self, cocoGt: COCO, cocoDt: COCO, iouType: str = "segm"):
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.iouType = iouType
        self.params = Params(iouType)
        self.params.imgIds = sorted(cocoGt.getImgIds())
        self.params.catIds = sorted(cocoGt.getCatIds())
        self.evalImgs = {}
        self.eval = {}
        self.stats = np.zeros(12)
        self.ious = {}

    # ------------------------------------------------------------------ #
    def _get_anns(self, coco, img_id, cat_id):
        ids = coco.getAnnIds(imgIds=[img_id], catIds=[cat_id])
        return coco.loadAnns(ids)

    def compute_iou(self, img_id, cat_id):
        p = self.params
        gt = self._get_anns(self.cocoGt, img_id, cat_id)
        dt = self._get_anns(self.cocoDt, img_id, cat_id)
        if len(gt) == 0 and len(dt) == 0:
            return np.zeros((0, 0))
        dt = sorted(dt, key=lambda a: -a.get("score", 0.0))[: p.maxDets[-1]]
        iscrowd = [a.get("iscrowd", 0) for a in gt]
        if self.iouType == "segm":
            g = [self.cocoGt.annToRLE(a) for a in gt]
            d = [self.cocoDt.annToRLE(a) for a in dt]
            return rle_util.iou_rle(d, g, iscrowd)
        g = np.array([a["bbox"] for a in gt], np.float64).reshape(-1, 4)
        d = np.array([a["bbox"] for a in dt], np.float64).reshape(-1, 4)
        return _bbox_iou_xywh(d, g, iscrowd)

    def evaluate_img(self, img_id, cat_id, area_rng, max_det):
        p = self.params
        gt = self._get_anns(self.cocoGt, img_id, cat_id)
        dt = self._get_anns(self.cocoDt, img_id, cat_id)
        if len(gt) == 0 and len(dt) == 0:
            return None
        for g in gt:
            too_small = g["area"] < area_rng[0] or g["area"] > area_rng[1]
            g["_ignore"] = 1 if (g.get("ignore", 0) or g.get("iscrowd", 0) or too_small) else 0
        gtind = np.argsort([g["_ignore"] for g in gt], kind="mergesort")
        gt = [gt[i] for i in gtind]
        dt = sorted(dt, key=lambda a: -a.get("score", 0.0))[:max_det]
        iscrowd = [int(g.get("iscrowd", 0)) for g in gt]
        ious = self.ious[(img_id, cat_id)]
        ious = ious[:, gtind] if len(ious) > 0 else ious

        T = len(p.iouThrs)
        G = len(gt)
        D = len(dt)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        gt_ig = np.array([g["_ignore"] for g in gt])
        dt_ig = np.zeros((T, D))
        if len(ious) > 0:
            for tind, t in enumerate(p.iouThrs):
                for dind, d in enumerate(dt):
                    iou = min([t, 1 - 1e-10])
                    m = -1
                    for gind, g in enumerate(gt):
                        if gtm[tind, gind] > 0 and not iscrowd[gind]:
                            continue
                        if m > -1 and gt_ig[m] == 0 and gt_ig[gind] == 1:
                            break
                        if ious[dind, gind] < iou:
                            continue
                        iou = ious[dind, gind]
                        m = gind
                    if m == -1:
                        continue
                    dt_ig[tind, dind] = gt_ig[m]
                    dtm[tind, dind] = gt[m]["id"]
                    gtm[tind, m] = d["id"]
        a = np.array(
            [d["area"] < area_rng[0] or d["area"] > area_rng[1] for d in dt]
        ).reshape(1, -1)
        dt_ig = np.logical_or(
            dt_ig, np.logical_and(dtm == 0, np.repeat(a, T, 0))
        )
        return {
            "dtMatches": dtm,
            "gtIgnore": gt_ig,
            "dtIgnore": dt_ig,
            "dtScores": np.array([d.get("score", 0.0) for d in dt]),
            "num_gt": int(np.count_nonzero(gt_ig == 0)),
        }

    def evaluate(self):
        p = self.params
        self.ious = {
            (i, c): self.compute_iou(i, c)
            for i in p.imgIds
            for c in p.catIds
        }
        self.evalImgs = {
            (i, c, tuple(a), m): self.evaluate_img(i, c, a, m)
            for c in p.catIds
            for a in p.areaRng
            for m in p.maxDets
            for i in p.imgIds
        }

    def accumulate(self):
        p = self.params
        T = len(p.iouThrs)
        R = len(p.recThrs)
        K = len(p.catIds)
        A = len(p.areaRng)
        M = len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))

        for k, cat in enumerate(p.catIds):
            for a, area in enumerate(p.areaRng):
                for m, max_det in enumerate(p.maxDets):
                    evals = [
                        self.evalImgs[(i, cat, tuple(area), max_det)]
                        for i in p.imgIds
                    ]
                    evals = [e for e in evals if e is not None]
                    if not evals:
                        continue
                    dt_scores = np.concatenate([e["dtScores"] for e in evals])
                    inds = np.argsort(-dt_scores, kind="mergesort")
                    dt_scores_sorted = dt_scores[inds]
                    dtm = np.concatenate([e["dtMatches"] for e in evals], 1)[:, inds]
                    dt_ig = np.concatenate([e["dtIgnore"] for e in evals], 1)[:, inds]
                    npig = sum(e["num_gt"] for e in evals)
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dt_ig))
                    fps = np.logical_and(
                        np.logical_not(dtm), np.logical_not(dt_ig)
                    )
                    tp_sum = np.cumsum(tps, 1).astype(np.float64)
                    fp_sum = np.cumsum(fps, 1).astype(np.float64)
                    for t in range(T):
                        tp = tp_sum[t]
                        fp = fp_sum[t]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / (fp + tp + np.spacing(1))
                        q = np.zeros(R)
                        ss = np.zeros(R)
                        recall[t, k, a, m] = rc[-1] if nd else 0
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds_r = np.searchsorted(rc, p.recThrs, side="left")
                        for ri, pi in enumerate(inds_r):
                            if pi < nd:
                                q[ri] = pr[pi]
                                ss[ri] = dt_scores_sorted[pi]
                        precision[t, :, k, a, m] = q
                        scores[t, :, k, a, m] = ss
        self.eval = {
            "precision": precision,
            "recall": recall,
            "scores": scores,
            "params": p,
        }

    def _summarize(self, ap=1, iouThr=None, areaRng="all", maxDets=100):
        p = self.params
        aind = [i for i, a in enumerate(p.areaRngLbl) if a == areaRng]
        mind = [i for i, m in enumerate(p.maxDets) if m == maxDets]
        if ap == 1:
            s = self.eval["precision"]
            if iouThr is not None:
                t = np.where(np.isclose(p.iouThrs, iouThr))[0]
                s = s[t]
            s = s[:, :, :, aind, mind]
        else:
            s = self.eval["recall"]
            if iouThr is not None:
                t = np.where(np.isclose(p.iouThrs, iouThr))[0]
                s = s[t]
            s = s[:, :, aind, mind]
        valid = s[s > -1]
        return float(np.mean(valid)) if valid.size else -1.0

    def summarize(self):
        d = self.params.maxDets
        self.stats = np.array(
            [
                self._summarize(1, maxDets=d[-1]),
                self._summarize(1, iouThr=0.5, maxDets=d[-1]),
                self._summarize(1, iouThr=0.75, maxDets=d[-1]),
                self._summarize(1, areaRng="small", maxDets=d[-1]),
                self._summarize(1, areaRng="medium", maxDets=d[-1]),
                self._summarize(1, areaRng="large", maxDets=d[-1]),
                self._summarize(0, maxDets=d[0]),
                self._summarize(0, maxDets=d[1] if len(d) > 1 else d[0]),
                self._summarize(0, maxDets=d[-1]),
                self._summarize(0, areaRng="small", maxDets=d[-1]),
                self._summarize(0, areaRng="medium", maxDets=d[-1]),
                self._summarize(0, areaRng="large", maxDets=d[-1]),
            ]
        )
        return self.stats

    def per_class_ap(self, iouThr=None, maxDets=100):
        """mAP per category (used by coco_inst_seg_eval,
        reference lib/datasets/json_inference.py:24-56)."""
        p = self.params
        out = {}
        mind = [i for i, m in enumerate(p.maxDets) if m == maxDets]
        for k, cat in enumerate(p.catIds):
            s = self.eval["precision"]
            if iouThr is not None:
                t = np.where(np.isclose(p.iouThrs, iouThr))[0]
                s = s[t]
            s = s[:, :, k, 0, mind]
            valid = s[s > -1]
            out[cat] = float(np.mean(valid)) if valid.size else -1.0
        return out


class Params:
    def __init__(self, iouType="segm"):
        self.iouType = iouType
        self.imgIds = []
        self.catIds = []
        self.iouThrs = np.linspace(0.5, 0.95, 10)
        self.recThrs = np.linspace(0.0, 1.0, 101)
        self.maxDets = [1, 10, 100]
        self.areaRng = [
            [0, 1e10],
            [0, 32**2],
            [32**2, 96**2],
            [96**2, 1e10],
        ]
        self.areaRngLbl = ["all", "small", "medium", "large"]
        self.useCats = 1


def _bbox_iou_xywh(d, g, iscrowd):
    """pycocotools bbox iou: xywh boxes, crowd gt uses dt area as union."""
    out = np.zeros((len(d), len(g)), np.float64)
    for j, gb in enumerate(g):
        gx1, gy1, gw, gh = gb
        g_area = gw * gh
        crowd = bool(iscrowd[j]) if iscrowd else False
        for i, db in enumerate(d):
            dx1, dy1, dw, dh = db
            iw = min(dx1 + dw, gx1 + gw) - max(dx1, gx1)
            ih = min(dy1 + dh, gy1 + gh) - max(dy1, gy1)
            if iw <= 0 or ih <= 0:
                continue
            inter = iw * ih
            union = dw * dh if crowd else dw * dh + g_area - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out
