"""PASCAL VOC detection evaluation + CorLoc.

Behavior contracts: reference lib/datasets/voc_eval.py (standard PASCAL
VOC AP protocol over devkit XML annotations, 11-point or integrated AP)
and lib/datasets/dis_eval.py (CorLoc over the train set). Detections are
passed in memory instead of the reference's per-class results files.
"""
from __future__ import annotations


import xml.etree.ElementTree as ET

import numpy as np


def parse_rec(filename):
    """Parse a PASCAL VOC xml annotation file."""
    tree = ET.parse(filename)
    objects = []
    for obj in tree.findall("object"):
        diff = obj.find("difficult")
        bbox = obj.find("bndbox")
        objects.append(
            {
                "name": obj.find("name").text,
                "difficult": int(diff.text) if diff is not None else 0,
                "bbox": [
                    int(float(bbox.find("xmin").text)),
                    int(float(bbox.find("ymin").text)),
                    int(float(bbox.find("xmax").text)),
                    int(float(bbox.find("ymax").text)),
                ],
            }
        )
    return objects


def voc_ap(rec, prec, use_07_metric=False):
    """AP from precision/recall (reference voc_eval.py voc_ap)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) > 0 else 0.0
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def _load_gt(annotations, imagenames, classname):
    """annotations: {imagename: [obj dicts]} (already parsed)."""
    class_recs = {}
    npos = 0
    for imagename in imagenames:
        r = [obj for obj in annotations[imagename] if obj["name"] == classname]
        bbox = np.array([x["bbox"] for x in r]).reshape(-1, 4)
        difficult = np.array([x["difficult"] for x in r]).astype(bool)
        npos += int(sum(~difficult))
        class_recs[imagename] = {
            "bbox": bbox,
            "difficult": difficult,
            "det": [False] * len(r),
        }
    return class_recs, npos


def voc_eval_boxes(
    detections, annotations, imagenames, classname, ovthresh=0.5,
    use_07_metric=False,
):
    """Per-class PASCAL VOC AP (reference voc_eval.py semantics).

    detections: list of (imagename, score, x1, y1, x2, y2) for this class.
    annotations: {imagename: parsed objects}.
    Returns (rec, prec, ap).
    """
    class_recs, npos = _load_gt(annotations, imagenames, classname)

    image_ids = [d[0] for d in detections]
    confidence = np.array([d[1] for d in detections], np.float64)
    bb_all = np.array([d[2:6] for d in detections], np.float64).reshape(-1, 4)

    sorted_ind = np.argsort(-confidence)
    bb_all = bb_all[sorted_ind]
    image_ids = [image_ids[i] for i in sorted_ind]

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        r = class_recs[image_ids[d]]
        bb = bb_all[d]
        ovmax = -np.inf
        jmax = -1
        bbgt = r["bbox"]
        if bbgt.size > 0:
            ixmin = np.maximum(bbgt[:, 0], bb[0])
            iymin = np.maximum(bbgt[:, 1], bb[1])
            ixmax = np.minimum(bbgt[:, 2], bb[2])
            iymax = np.minimum(bbgt[:, 3], bb[3])
            iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
            ih = np.maximum(iymax - iymin + 1.0, 0.0)
            inters = iw * ih
            uni = (
                (bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
                + (bbgt[:, 2] - bbgt[:, 0] + 1.0) * (bbgt[:, 3] - bbgt[:, 1] + 1.0)
                - inters
            )
            overlaps = inters / uni
            ovmax = np.max(overlaps)
            jmax = int(np.argmax(overlaps))
        if ovmax > ovthresh:
            if not r["difficult"][jmax]:
                if not r["det"][jmax]:
                    tp[d] = 1.0
                    r["det"][jmax] = True
                else:
                    fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    ap = voc_ap(rec, prec, use_07_metric)
    return rec, prec, ap


def dis_eval_boxes(detections, annotations, imagenames, classname, ovthresh=0.5):
    """CorLoc for one class — the EXACT reference algorithm
    (lib/datasets/dis_eval.py:35-141): every detection whose max IoU with
    a same-class gt exceeds ovthresh counts as a tp, and the result is
    sum(tp) / #images-containing-the-class. The protocol feeds this from
    box_results_for_corloc (one argmax detection per class per image,
    lib/core/test.py:320-352), which makes it the CorLoc fraction; with
    multiple detections per image the raw count semantics are preserved
    (verified against the executed reference,
    tests/test_reference_exec_voc_eval.py)."""
    class_recs = {}
    nimgs = 0.0
    for imagename in imagenames:
        r = [obj for obj in annotations[imagename] if obj["name"] == classname]
        bbox = np.array([x["bbox"] for x in r]).reshape(-1, 4)
        nimgs += float(len(r) > 0)
        class_recs[imagename] = {"bbox": bbox}

    tp = 0.0
    for d in detections:
        bbgt = class_recs[d[0]]["bbox"].astype(np.float64)
        if bbgt.size == 0:
            continue
        bb = np.array(d[2:6], np.float64)
        ixmin = np.maximum(bbgt[:, 0], bb[0])
        iymin = np.maximum(bbgt[:, 1], bb[1])
        ixmax = np.minimum(bbgt[:, 2], bb[2])
        iymax = np.minimum(bbgt[:, 3], bb[3])
        iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
        ih = np.maximum(iymax - iymin + 1.0, 0.0)
        inters = iw * ih
        uni = (
            (bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
            + (bbgt[:, 2] - bbgt[:, 0] + 1.0) * (bbgt[:, 3] - bbgt[:, 1] + 1.0)
            - inters
        )
        if np.max(inters / uni) > ovthresh:
            tp += 1.0
    return tp / max(nimgs, 1.0)


def load_annotations(annopath, imagenames):
    """Parse all annotation xmls ({imagename: objects})."""
    return {name: parse_rec(annopath.format(name)) for name in imagenames}
