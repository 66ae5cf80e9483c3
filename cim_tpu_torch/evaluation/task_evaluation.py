"""Evaluation dispatcher + expected-results regression gate.

Behavior contracts: reference lib/datasets/task_evaluation.py
(evaluate_all :51-86, "copypaste:" result lines :89-100,
check_expected_results :103-156) and voc_dataset_evaluator.py
(:39-183 python VOC eval + CorLoc dispatch).
"""
from __future__ import annotations

import logging
import os
from collections import OrderedDict

import numpy as np

from cim_tpu_torch.data.voc_meta import classes_for
from cim_tpu_torch.evaluation.voc_eval import (
    dis_eval_boxes,
    load_annotations,
    voc_eval_boxes,
)

logger = logging.getLogger(__name__)


def _voc_info(dataset):
    year = dataset.name[4:8]
    image_set = dataset.name[9:]
    devkit = dataset.devkit_dir
    return {
        "year": year,
        "image_set": image_set,
        "devkit_path": devkit,
        "anno_path": os.path.join(devkit, f"VOC{year}", "Annotations", "{}.xml"),
        "image_set_path": os.path.join(
            devkit, f"VOC{year}", "ImageSets", "Main", f"{image_set}.txt"
        ),
    }


def _dets_by_class(dataset, all_boxes, imagenames):
    """all_boxes[cls][img] = (n, 5) dets -> per-class flat lists keyed by
    VOC imagename.

    Detections get +1 on every coordinate: the reference writes its VOC
    result files 1-based (voc_dataset_evaluator.py:96-98) and voc_eval
    parses the xml gt RAW (voc_eval.py:45, no -1), so the matching runs
    in 1-based coordinates on both sides. Our pipeline's 0-based dets
    must be lifted the same way or every det box sits one pixel
    up-and-left of the reference protocol's, shifting borderline IoU
    matches and the resulting mAP/CorLoc.

    Coordinates and scores are additionally rounded through the
    reference's result-file formats ('{:.1f}' / '{:.3f}',
    voc_dataset_evaluator.py:96-98) — the reference evaluates what it
    re-parses from disk, so full-precision floats here could flip
    borderline IoU>thresh comparisons relative to a byte-faithful run."""
    classes = classes_for(dataset.num_classes)
    out = {c: [] for c in classes}
    for j, cls in enumerate(classes):
        cls_dets = all_boxes[j + 1]
        for im_i, dets in enumerate(cls_dets):
            if len(dets) == 0:
                continue
            name = imagenames[im_i]
            for d in dets:
                out[cls].append(
                    (
                        name,
                        float(f"{float(d[4]):.3f}"),
                        float(f"{d[0] + 1:.1f}"),
                        float(f"{d[1] + 1:.1f}"),
                        float(f"{d[2] + 1:.1f}"),
                        float(f"{d[3] + 1:.1f}"),
                    )
                )
    return out


def evaluate_boxes_voc(dataset, all_boxes, output_dir, test_corloc=False,
                       use_07_metric=False):
    """VOC detection mAP or CorLoc (reference voc_dataset_evaluator)."""
    info = _voc_info(dataset)
    with open(info["image_set_path"]) as f:
        imagenames = [line.strip() for line in f]
    annotations = load_annotations(info["anno_path"], imagenames)
    dets = _dets_by_class(dataset, all_boxes, imagenames)
    classes = classes_for(dataset.num_classes)

    results = OrderedDict()
    vals = []
    for cls in classes:
        if test_corloc:
            val = dis_eval_boxes(dets[cls], annotations, imagenames, cls)
        else:
            _, _, val = voc_eval_boxes(
                dets[cls], annotations, imagenames, cls,
                use_07_metric=use_07_metric,
            )
        results[cls] = float(val)
        vals.append(val)
    mean_val = float(np.mean(vals))
    key = "CorLoc" if test_corloc else "AP"
    logger.info("Mean %s = %.4f", key, mean_val)
    for cls, v in results.items():
        logger.info("%s: %.4f", cls, v)
    log_copy_paste_friendly_results({key: {"mean": mean_val, **results}})
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        import json

        with open(os.path.join(output_dir, f"voc_{key}.json"), "w") as f:
            json.dump({"mean": mean_val, **results}, f, indent=2)
    return {key: mean_val, "per_class": results}


def evaluate_boxes_coco(dataset, all_boxes, output_dir):
    """COCO bbox eval via the in-repo COCOeval
    (reference lib/datasets/json_dataset_evaluator.py:38-56)."""
    from cim_tpu_torch.evaluation.coco import COCOeval

    results_json = []
    image_ids = sorted(dataset.COCO.getImgIds())
    for j in range(1, dataset.num_classes + 1):
        cat_id = dataset.contiguous_category_id_to_json_id[j - 1]
        for im_i, dets in enumerate(all_boxes[j]):
            for d in np.asarray(dets).reshape(-1, 5):
                x1, y1, x2, y2, s = d
                results_json.append(
                    {
                        "image_id": image_ids[im_i],
                        "category_id": cat_id,
                        "bbox": [
                            float(x1),
                            float(y1),
                            float(x2 - x1 + 1),
                            float(y2 - y1 + 1),
                        ],
                        "score": float(s),
                    }
                )
    coco_dt = dataset.COCO.loadRes(results_json)
    ev = COCOeval(dataset.COCO, coco_dt, iouType="bbox")
    ev.evaluate()
    ev.accumulate()
    stats = ev.summarize()
    log_copy_paste_friendly_results({"box": {"AP": stats[0], "AP50": stats[1]}})
    return {"AP": float(stats[0]), "AP50": float(stats[1]), "stats": stats}


def evaluate_all(dataset, all_boxes, output_dir, test_corloc=False):
    """Dispatch on dataset name (reference task_evaluation.evaluate_all)."""
    if dataset.name.startswith("voc_"):
        return evaluate_boxes_voc(
            dataset, all_boxes, output_dir, test_corloc=test_corloc
        )
    return evaluate_boxes_coco(dataset, all_boxes, output_dir)


def log_copy_paste_friendly_results(results):
    """Spreadsheet-friendly 'copypaste:' lines
    (reference task_evaluation.py:89-100)."""
    for task, metrics in results.items():
        logger.info("copypaste: Task: %s", task)
        names = list(metrics.keys())
        vals = [
            f"{metrics[k]:.4f}" if isinstance(metrics[k], float) else str(metrics[k])
            for k in names
        ]
        logger.info("copypaste: %s", ",".join(map(str, names)))
        logger.info("copypaste: %s", ",".join(vals))


def check_expected_results(results, expected, atol=0.005, rtol=0.1):
    """Regression gate (reference task_evaluation.py:103-156;
    cfg.EXPECTED_RESULTS entries [dataset, task, metric, value]).

    `results` may be the nested reference shape results[task][metric] or
    the flat dict evaluate_all returns here ({"AP": ..., "AP50": ...});
    both resolve."""
    failures = []
    for dataset_name, task, metric, expected_val in expected:
        node = results.get(task)
        actual = node.get(metric) if isinstance(node, dict) else results.get(metric)
        if not isinstance(actual, (int, float)):
            actual = None
        if actual is None:
            failures.append(f"missing metric {task}/{metric}")
            continue
        err = abs(actual - expected_val)
        tol = atol + rtol * abs(expected_val)
        line = (
            f"{task}/{metric}: {actual:.4f} (expected {expected_val:.4f} "
            f"+/- {tol:.4f}) on {dataset_name}"
        )
        if err > tol:
            failures.append("FAIL: " + line)
            logger.error("FAIL: %s", line)
        else:
            logger.info("PASS: %s", line)
    return failures
