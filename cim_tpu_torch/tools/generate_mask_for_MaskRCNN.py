"""Pseudo-label exporter for Mask R-CNN (port of
tools/generate_mask_for_MaskRCNN.py; reference
tools/generate_mask_for_MaskRCNN.py:79-305 and lib/pycococreatortools).

    python -m cim_tpu_torch.tools.generate_mask_for_MaskRCNN --cfg configs/resnet50_voc.yaml \\
        --result_path Outputs/resnet50_voc/test/discovery.pkl \\
        --cob_dir data/VOC2012/COB --output_dir Outputs/pseudo

From test_net's train-set discovery.pkl: per image and per gt class
present in it, score threshold and NMS with proposal indices
(evaluation.mask_results); every survivor, or only the best (--is_best),
becomes a COCO annotation whose segmentation is its proposal's mask (from
--cob_dir's .mat files at full resolution, else the 7x7 mask pasted into
its box). Writes <output_dir>/msrcnn_pseudo_label[_best].json; filter it
by score with change_mask_thr. Host only: no tensor goes to a card.
Workers come from a spawn context, as in tools/evaluation.py.

Unlike cim_tpu's exporter, --cob_dir works: cim_tpu passes the image id
to load_cob_masks, which takes the roidb entry; the port passes the entry
and the dataset's naming scheme (COCO or VOC), as evaluation does. And a
TEST.BBOX_AUG UNION record (M passes' rows over the same N proposals)
maps each kept row to its proposal (mask_results.proposal_index), where
cim_tpu indexes the proposals by the row.
"""
from __future__ import annotations

import argparse
import logging
import multiprocessing as mp
import os

import numpy as np

logger = logging.getLogger("cim_tpu_torch.tools.generate_mask")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Export pseudo labels")
    parser.add_argument("--cfg", dest="cfg_file", required=True)
    parser.add_argument("--set", dest="set_cfgs", nargs="+", default=None)
    parser.add_argument("--result_path", required=True, help="discovery.pkl")
    parser.add_argument("--dataset", default="voc2012trainaug")
    parser.add_argument("--cob_dir", default=None, help="full-res COB .mat directory")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--is_best", action="store_true",
                        help="keep only the best-scoring instance per class")
    parser.add_argument("--nprocs", type=int, default=8)
    return parser.parse_args(argv)


def create_image_info(image_id, file_name, image_size):
    """(reference lib/pycococreatortools create_image_info)."""
    return {"id": image_id, "file_name": file_name, "width": image_size[0],
            "height": image_size[1]}


def create_annotation_info(instance_id, image_id, category_id, mask, score, image_size):
    """A COCO annotation with RLE segmentation and score, or None for an
    empty mask (reference pycococreatortools.create_annotation_info_v1)."""
    from cim_tpu_torch.evaluation import rle as rle_util

    enc = rle_util.encode(np.asarray(mask, np.uint8))
    area = int(rle_util.area(enc))
    if area == 0:
        return None
    return {
        "id": instance_id,
        "image_id": image_id,
        "category_id": category_id,
        "iscrowd": 0,
        "area": area,
        "bbox": rle_util.to_bbox(enc).tolist(),
        "segmentation": enc,
        "score": float(score),
        "width": image_size[0],
        "height": image_size[1],
    }


def export_shard(payload):
    """(opts, entries, detections, cob_dir) -> (images, annotations)."""
    from cim_tpu_torch.config import get_default_cfg
    from cim_tpu_torch.data.voc_meta import coco_nummap_id
    from cim_tpu_torch.evaluation.mask_results import (
        mask_results_with_nms_and_limit_get_index,
        proposal_index,
    )
    from cim_tpu_torch.tools.evaluation import _paste_7x7, load_cob_masks

    opts, entries, detections, cob_dir = payload
    cfg = get_default_cfg()
    cfg.MODEL.NUM_CLASSES = opts["num_classes"]
    cfg.TEST.SCORE_THRESH = opts["score_thresh"]
    cfg.TEST.NMS = opts["nms"]
    is_voc = opts["num_classes"] == 20

    images, annotations = [], []
    instance_id = 1
    for entry in entries:
        rec = detections[entry["image"]]
        scores = np.asarray(rec["scores"])
        boxes = np.asarray(rec["boxes"])
        img_id = int(entry["id"])
        img_size = (entry["width"], entry["height"])
        masks_full = (load_cob_masks(cob_dir, entry, coco_scheme=opts.get("coco_scheme", False))
                      if cob_dir is not None else None)

        _, _, cls_boxes, cls_inds = mask_results_with_nms_and_limit_get_index(
            cfg, scores, boxes, 100)
        images.append(create_image_info(img_id, os.path.basename(entry["image"]), img_size))
        gt = entry["gt_classes"].reshape(-1)
        for cls_idx in range(1, opts["num_classes"] + 1):
            if gt[cls_idx - 1] <= 0:
                continue
            dets, inds = cls_boxes[cls_idx], cls_inds[cls_idx]
            if len(dets) == 0:
                continue
            order = np.argsort(-dets[:, 4])
            best_score = dets[order[0], 4]
            category_id = int(cls_idx) if is_voc else coco_nummap_id[int(cls_idx) - 1]
            for i in order:
                score = dets[i, 4]
                if opts["is_best"] and score != best_score:
                    continue
                cob_ind = proposal_index(inds[i], len(scores), len(entry["boxes"]))
                if masks_full is not None:
                    mask = masks_full[cob_ind]
                else:
                    mask = _paste_7x7(entry["masks"][cob_ind], entry["boxes"][cob_ind],
                                      entry["height"], entry["width"])
                info = create_annotation_info(instance_id, img_id, category_id, mask, score,
                                              img_size)
                if info is not None:
                    annotations.append(info)
                    instance_id += 1
    return images, annotations


def main(argv=None):
    """Run the CLI; returns the path of the JSON written."""
    from cim_tpu_torch.config import cfg_from_file, cfg_from_list, get_default_cfg
    from cim_tpu_torch.data.json_dataset import JsonDataset
    from cim_tpu_torch.data.voc_meta import classes_for
    from cim_tpu_torch.engine.stats import setup_logging
    from cim_tpu_torch.utils.io import load_object, save_json

    setup_logging()
    args = parse_args(argv)
    cfg = get_default_cfg()
    cfg_from_file(cfg, args.cfg_file)
    if args.dataset == "voc2012trainaug":
        train_name = "voc_2012_trainaug"
        cfg.MODEL.NUM_CLASSES = 20
    elif args.dataset == "coco2017train":
        train_name = "coco_2017_train"
        cfg.MODEL.NUM_CLASSES = 80
    else:
        raise ValueError(args.dataset)
    # --set after the dataset preset (cim_tpu's order, :171-174): an
    # explicit override such as MODEL.NUM_CLASSES is kept
    if args.set_cfgs:
        cfg_from_list(cfg, args.set_cfgs)

    detections = load_object(args.result_path)

    dataset = JsonDataset(cfg, train_name)
    roidb = dataset.get_roidb(
        gt=True, proposal_file=cfg.TRAIN.PROPOSAL_FILES[0] if cfg.TRAIN.PROPOSAL_FILES else None)
    roidb = [e for e in roidb if e["image"] in detections and not e["flipped"]]

    opts = {
        "num_classes": cfg.MODEL.NUM_CLASSES,
        "score_thresh": cfg.TEST.SCORE_THRESH,
        "nms": cfg.TEST.NMS,
        "is_best": args.is_best,
        "coco_scheme": "coco" in train_name,
    }
    shards = [roidb[i:: args.nprocs] for i in range(args.nprocs)]
    work = [(opts, s, {e["image"]: detections[e["image"]] for e in s}, args.cob_dir)
            for s in shards if s]
    if len(work) > 1:
        with mp.get_context("spawn").Pool(len(work)) as pool:
            outs = pool.map(export_shard, work)
    else:
        outs = [export_shard(w) for w in work]

    coco_output = {
        "images": [im for o in outs for im in o[0]],
        "annotations": [],
        "categories": [{"id": i + 1, "name": c, "supercategory": "object"}
                       for i, c in enumerate(classes_for(cfg.MODEL.NUM_CLASSES))],
    }
    for instance_id, a in enumerate((a for _, anns in outs for a in anns), start=1):
        a["id"] = instance_id
        coco_output["annotations"].append(a)

    name = "msrcnn_pseudo_label_best.json" if args.is_best else "msrcnn_pseudo_label.json"
    out_path = os.path.join(args.output_dir, name)
    save_json(coco_output, out_path)
    logger.info("Wrote %d images / %d annotations to %s", len(coco_output["images"]),
                len(coco_output["annotations"]), out_path)
    return out_path


if __name__ == "__main__":
    main()
