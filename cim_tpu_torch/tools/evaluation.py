"""Instance-segmentation evaluation CLI, the paper's headline metric (port
of tools/evaluation.py; reference tools/evaluation.py and
lib/datasets/json_inference.py).

    python -m cim_tpu_torch.tools.evaluation --cfg configs/resnet50_voc.yaml \\
        --result_path Outputs/resnet50_voc/test/detections.pkl \\
        --dataset voc2012sbdval --cob_dir data/VOC2012/COB_SBD_val

From test_net's detections.pkl: optionally zero the scores of proposals
whose box covers less than 2e-5 or more than 0.85 of the image
(TEST.PROPOSAL_FILTER), keep per class the NMS survivors with their
proposal indices (evaluation.mask_results), encode each survivor's
full-resolution COB mask (from --cob_dir's .mat files, else its 7x7 mask
pasted into its box) as RLE into segm_results.json, then COCOeval 'segm'
at IoU {0.25, 0.5, 0.7, 0.75} into inst_seg_metrics.json. Host only: no
tensor goes to a card.

Images are split round-robin over --nprocs worker processes from a spawn
context: main() may run in a process that has initialised CUDA (as
chip_smoke.py's does), and a forked child of such a process must not touch
CUDA, nor fork safely from a process with threads. The workers import
torch through ops.nms but run only numpy and the C++ host kernels.
"""
from __future__ import annotations

import argparse
import logging
import multiprocessing as mp
import os

import numpy as np

logger = logging.getLogger("cim_tpu_torch.tools.evaluation")

SEG_IOU_THRS = (0.25, 0.5, 0.7, 0.75)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Instance-seg evaluation")
    parser.add_argument("--cfg", dest="cfg_file", required=True)
    parser.add_argument("--set", dest="set_cfgs", nargs="+", default=None)
    parser.add_argument("--result_path", required=True, help="detections.pkl from test_net")
    parser.add_argument("--dataset", default="voc2012sbdval")
    parser.add_argument("--cob_dir", default=None,
                        help="directory with full-res COB .mat proposals; "
                        "default: the proposal pkl's 7x7 masks pasted into their boxes")
    parser.add_argument("--output_dir", default=None)
    parser.add_argument("--nprocs", type=int, default=8)
    parser.add_argument("--save_name", default="segm_results.json")
    return parser.parse_args(argv)


def cob_mat_name(entry) -> str:
    """The VOC scheme's .mat file name of a roidb entry: the image id
    YYYYNNNNNN as YYYY_NNNNNN.mat (reference tools/evaluation.py:104-105)."""
    s = str(int(entry["id"]))
    return s[:4] + "_" + s[4:] + ".mat"


def load_cob_masks(cob_dir, entry, coco_scheme=False):
    """Full-resolution COB proposal masks of one roidb entry (reference
    tools/evaluation.py:89-106). VOC scheme: cob_mat_name(entry), the
    cell array maskmat[:, 0]. COCO scheme: the image's basename .jpg ->
    .mat, trying the COCO_train2014_ / COCO_val2014_ prefixes first."""
    from scipy.io import loadmat

    if coco_scheme:
        base = os.path.basename(entry["image"]).rsplit(".", 1)[0] + ".mat"
        for cand in ("COCO_train2014_" + base, "COCO_val2014_" + base, base):
            path = os.path.join(cob_dir, cand)
            if os.path.exists(path):
                break
        proposals = loadmat(path, verify_compressed_data_integrity=False)["maskmat"].reshape(-1)
    else:
        proposals = loadmat(os.path.join(cob_dir, cob_mat_name(entry)))["maskmat"][:, 0]
    return [np.asarray(p) for p in proposals]


def _paste_7x7(mask7, box, height, width):
    """A 7x7 proposal mask resized (nearest) into its rounded box."""
    import cv2

    x1, y1, x2, y2 = [int(round(v)) for v in box]
    x2 = max(x2, x1 + 1)
    y2 = max(y2, y1 + 1)
    out = np.zeros((height, width), np.uint8)
    patch = cv2.resize(mask7.astype(np.uint8), (x2 - x1 + 1, y2 - y1 + 1),
                       interpolation=cv2.INTER_NEAREST)
    out[y1: y2 + 1, x1: x2 + 1] = patch[: out.shape[0] - y1, : out.shape[1] - x1]
    return out


def eval_shard(args_tuple):
    """(opts, entries, detections, cob_dir, cat_ids) -> the COCO segm
    results of the entries. A worker rebuilds its cfg from ``opts``."""
    from cim_tpu_torch.config import get_default_cfg
    from cim_tpu_torch.evaluation.mask_results import (
        coco_encode,
        mask_results_with_nms_and_limit_get_index,
        proposal_index,
    )

    opts, entries, detections, cob_dir, cat_ids = args_tuple
    cfg = get_default_cfg()
    cfg.MODEL.NUM_CLASSES = opts["num_classes"]
    cfg.TEST.SCORE_THRESH = opts["score_thresh"]
    cfg.TEST.NMS = opts["nms"]
    cfg.TEST.PROPOSAL_FILTER = opts["proposal_filter"]
    cfg.TEST.DETECTIONS_PER_IM = opts.get("detections_per_im", 100)

    results = []
    for entry in entries:
        rec = detections[entry["image"]]
        scores = np.asarray(rec["scores"])
        boxes = np.asarray(rec["boxes"])
        masks_full = (load_cob_masks(cob_dir, entry, coco_scheme=opts["coco_scheme"])
                      if cob_dir is not None else None)
        if cfg.TEST.PROPOSAL_FILTER:
            # box areas against the image's (reference :107-116, :198),
            # whatever the mask source
            areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            im_area = entry["height"] * entry["width"]
            bad = (areas < 2e-5 * im_area) | (areas > 0.85 * im_area)
            scores = scores.copy()
            scores[bad] = 0.0

        _, _, cls_boxes, cls_inds = mask_results_with_nms_and_limit_get_index(
            cfg, scores, boxes, cfg.TEST.DETECTIONS_PER_IM)
        for j in range(1, cfg.MODEL.NUM_CLASSES + 1):
            for d, row in zip(cls_boxes[j], cls_inds[j]):
                idx = proposal_index(row, len(scores), len(entry["boxes"]))
                if masks_full is not None:
                    mask = np.asarray(masks_full[int(idx)], np.uint8)
                else:
                    mask = _paste_7x7(entry["masks"][int(idx)], entry["boxes"][int(idx)],
                                      entry["height"], entry["width"])
                results.append({
                    "image_id": int(entry["id"]),
                    "category_id": int(cat_ids[j - 1]),
                    "segmentation": coco_encode(mask),
                    "score": float(d[4]),
                })
    return results


def coco_inst_seg_eval(gt_coco, res_json, iou_thrs=SEG_IOU_THRS):
    """Instance-seg mAP at the CIM thresholds (reference
    lib/datasets/json_inference.py:24-56): the mean over classes of the
    per-class AP (maxDets 100) that is not -1."""
    from cim_tpu_torch.evaluation.coco import COCOeval

    coco_dt = gt_coco.loadRes(res_json)
    ev = COCOeval(gt_coco, coco_dt, iouType="segm")
    ev.params.iouThrs = np.array(iou_thrs)
    ev.params.maxDets = [1, 10, 100]
    ev.evaluate()
    ev.accumulate()
    out = {}
    for t in iou_thrs:
        per_class = ev.per_class_ap(iouThr=t, maxDets=100)
        valid = [v for v in per_class.values() if v > -1]
        out[f"mAP{int(t * 100)}"] = float(np.mean(valid)) if valid else -1.0
        out[f"per_class_AP{int(t * 100)}"] = per_class
    return out


def main(argv=None):
    """Run the CLI; returns the metrics (inst_seg_metrics.json's)."""
    from cim_tpu_torch.config import assert_and_infer_cfg, load_cfg
    from cim_tpu_torch.data.json_dataset import JsonDataset
    from cim_tpu_torch.engine.stats import setup_logging
    from cim_tpu_torch.utils.io import load_object, save_json

    setup_logging()
    args = parse_args(argv)
    # --set first, then the dataset preset (cim_tpu's order, :193-199)
    cfg = load_cfg(args.cfg_file, args.set_cfgs)
    if args.dataset == "voc2012sbdval":
        cfg.TEST.DATASETS = ("voc_2012_sbdval",)
        cfg.MODEL.NUM_CLASSES = 20
    elif args.dataset == "coco2017val":
        cfg.TEST.DATASETS = ("coco_2017_val",)
        cfg.MODEL.NUM_CLASSES = 80
    assert_and_infer_cfg(cfg, make_immutable=False)

    detections = load_object(args.result_path)
    if isinstance(detections, dict) and "all_boxes" in detections:
        # the reference's pickle, {'all_boxes': {image: {scores, boxes}}} (:191-193)
        detections = detections["all_boxes"]

    dataset = JsonDataset(cfg, cfg.TEST.DATASETS[0])
    roidb = dataset.get_roidb(
        gt=True, proposal_file=cfg.TEST.PROPOSAL_FILES[0] if cfg.TEST.PROPOSAL_FILES else None)
    roidb = [e for e in roidb if e["image"] in detections]
    cat_ids = [dataset.contiguous_category_id_to_json_id[i] for i in range(cfg.MODEL.NUM_CLASSES)]

    opts = {
        "num_classes": cfg.MODEL.NUM_CLASSES,
        "score_thresh": cfg.TEST.SCORE_THRESH,
        "nms": cfg.TEST.NMS,
        "proposal_filter": cfg.TEST.PROPOSAL_FILTER,
        "detections_per_im": cfg.TEST.DETECTIONS_PER_IM,
        "coco_scheme": "coco" in cfg.TEST.DATASETS[0],
    }
    shards = [roidb[i:: args.nprocs] for i in range(args.nprocs)]
    # each worker gets only its images' detections
    work = [(opts, shard, {e["image"]: detections[e["image"]] for e in shard}, args.cob_dir,
             cat_ids) for shard in shards if shard]
    if args.nprocs > 1 and len(work) > 1:
        with mp.get_context("spawn").Pool(len(work)) as pool:
            all_results = pool.map(eval_shard, work)
    else:
        all_results = [eval_shard(w) for w in work]
    results = [r for shard in all_results for r in shard]

    output_dir = args.output_dir or os.path.dirname(args.result_path)
    out_json = os.path.join(output_dir, args.save_name)
    save_json(results, out_json)
    logger.info("Wrote %d segm results to %s", len(results), out_json)

    metrics = coco_inst_seg_eval(dataset.COCO, results)
    for k, v in metrics.items():
        if not k.startswith("per_class"):
            logger.info("%s: %.4f", k, v)
    save_json(metrics, os.path.join(output_dir, "inst_seg_metrics.json"), indent=2, default=float)
    return metrics


if __name__ == "__main__":
    main()
