"""Inference loop: dataset -> fused TTA -> detections -> NMS -> evaluation
(port of cim_tpu/engine/test_engine.py, single process).

Behaviour contracts (reference lib/core/test_engine.py): test_net loops
the roidb calling im_detect_all and pickles {image: {scores, boxes}} as
detections.pkl (val) or discovery.pkl (train CorLoc); run_inference then
applies box_results_with_nms_and_limit (or box_results_for_corloc) per
image and calls task_evaluation.evaluate_all. The dataset, roidb and
metric code are the port's copies of cim_tpu's host modules. The cross-image
batched evaluator (TPU.EVAL_BATCH > 1), the overlap of host NMS with the
next image and the multi-process fan-out are not ported yet.
"""
from __future__ import annotations

import logging
import os
import pickle
from collections import defaultdict

from cim_tpu_torch.data.json_dataset import JsonDataset
from cim_tpu_torch.engine.stats import Timer
from cim_tpu_torch.engine.test import (
    Evaluator,
    box_results_for_corloc,
    box_results_with_nms_and_limit,
)

logger = logging.getLogger(__name__)


def get_roidb_and_dataset(cfg, dataset_name, proposal_file, ind_range=None):
    """(reference test_engine.get_roidb_and_dataset :359-392)."""
    dataset = JsonDataset(cfg, dataset_name)
    roidb = dataset.get_roidb(gt=True, proposal_file=proposal_file)
    total = len(roidb)
    start, end = (0, total) if ind_range is None else ind_range
    return roidb[start:end], dataset, start, end, total


def empty_results(num_classes, num_images):
    """all_boxes[cls][image] = N x 5 [x1, y1, x2, y2, score]."""
    return [[[] for _ in range(num_images)] for _ in range(num_classes + 1)]


def _det_basename(check_corloc: bool) -> str:
    return "discovery" if check_corloc else "detections"


def _default_image_loader(entry):
    import cv2

    im = cv2.imread(entry["image"])
    if im is None:
        raise FileNotFoundError(f"cannot read {entry['image']}")
    return im


def test_net(
    cfg,
    model,
    dataset_name,
    proposal_file,
    output_dir,
    ind_range=None,
    check_corloc=False,
    image_loader=None,
    evaluator=None,
    device="cuda",
):
    """Single-device dataset loop. model: a CIMModel on ``device`` (the
    card unless the caller passes device="cpu").
    image_loader(entry) -> (H, W, 3) uint8 BGR image (defaults to
    cv2.imread). evaluator: a prebuilt Evaluator to reuse."""
    if int(cfg.TPU.EVAL_BATCH or 1) > 1:
        raise NotImplementedError(
            "TPU.EVAL_BATCH > 1 (the cross-image BatchedEvaluator) is not ported yet; set it to 1"
        )
    roidb, dataset, start_ind, end_ind, total_num_images = get_roidb_and_dataset(
        cfg, dataset_name, proposal_file, ind_range
    )
    num_images = len(roidb)
    image_loader = image_loader or _default_image_loader
    evaluator = evaluator or Evaluator(cfg, model, device=device)
    timers = defaultdict(Timer)
    all_scores = {}
    for i, entry in enumerate(roidb):
        im = image_loader(entry)
        timers["im_detect_bbox"].tic()
        scores, boxes = evaluator.im_detect_all(im, entry["boxes"], entry["masks"])
        timers["im_detect_bbox"].toc()
        all_scores[entry["image"]] = {"scores": scores, "boxes": boxes}
        if i % 10 == 0:
            ave = timers["im_detect_bbox"].average_time
            logger.info(
                "im_detect: range [%d, %d] of %d: %d/%d %.3fs (eta: %ds)",
                start_ind + 1, end_ind, total_num_images, start_ind + i + 1,
                start_ind + num_images, ave, int((num_images - i - 1) * ave),
            )

    det_name = _det_basename(check_corloc) + ".pkl"
    if ind_range is not None:
        det_name = f"{det_name[:-4]}_range_{ind_range[0]}_{ind_range[1]}.pkl"
    os.makedirs(output_dir, exist_ok=True)
    det_file = os.path.join(output_dir, det_name)
    with open(det_file, "wb") as f:
        pickle.dump(all_scores, f, pickle.HIGHEST_PROTOCOL)
    logger.info("Wrote detections to: %s", os.path.abspath(det_file))
    return all_scores, roidb, dataset


def post_process_results(cfg, all_scores, roidb, dataset, check_corloc=False):
    """Per-image NMS + limit (or CorLoc argmax) -> all_boxes
    (reference test_engine.py:188-197)."""
    all_boxes = empty_results(cfg.MODEL.NUM_CLASSES, len(roidb))
    post = box_results_for_corloc if check_corloc else box_results_with_nms_and_limit
    for i, entry in enumerate(roidb):
        rec = all_scores[entry["image"]]
        _, _, cls_boxes_i = post(cfg, rec["scores"], rec["boxes"])
        for j in range(1, cfg.MODEL.NUM_CLASSES + 1):
            all_boxes[j][i] = cls_boxes_i[j]
    return all_boxes


def run_inference(
    cfg,
    model,
    output_dir,
    check_corloc=False,
    check_expected_results=False,
    image_loader=None,
    ind_range=None,
    evaluator=None,
    device="cuda",
):
    """Top-level inference + evaluation (reference run_inference :90-151).
    With ind_range only that slice is processed and pickled, and
    evaluation is skipped. Returns (results, all_boxes, all_scores)."""
    dataset_name = cfg.TEST.DATASETS[0]
    proposal_file = cfg.TEST.PROPOSAL_FILES[0] if cfg.TEST.PROPOSAL_FILES else None
    all_scores, roidb, dataset = test_net(
        cfg, model, dataset_name, proposal_file, output_dir,
        ind_range=tuple(ind_range) if ind_range else None,
        check_corloc=check_corloc, image_loader=image_loader,
        evaluator=evaluator, device=device,
    )
    if ind_range:
        return None, None, all_scores
    return _post_process_and_evaluate(
        cfg, all_scores, roidb, dataset, output_dir, check_corloc,
        check_expected_results,
    )


def _post_process_and_evaluate(cfg, all_scores, roidb, dataset, output_dir,
                               check_corloc, check_expected_results):
    """Per-image NMS/CorLoc post-processing, evaluate_all and the
    expected-results gate."""
    from cim_tpu_torch.evaluation import task_evaluation

    all_boxes = post_process_results(cfg, all_scores, roidb, dataset, check_corloc)
    results = task_evaluation.evaluate_all(
        dataset, all_boxes, output_dir, test_corloc=check_corloc
    )
    if check_expected_results and cfg.EXPECTED_RESULTS:
        failures = task_evaluation.check_expected_results(
            results, cfg.EXPECTED_RESULTS,
            atol=cfg.EXPECTED_RESULTS_ATOL, rtol=cfg.EXPECTED_RESULTS_RTOL,
        )
        if failures and cfg.EXPECTED_RESULTS_EMAIL:
            # reference lib/utils/logging.py:86-92 (email on regression)
            from cim_tpu_torch.engine.stats import send_failure_email

            send_failure_email(
                "CIM expected-results regression", "\n".join(failures),
                cfg.EXPECTED_RESULTS_EMAIL,
            )
        if failures:
            raise AssertionError("expected results not met: " + "; ".join(failures))
    return results, all_boxes, all_scores
