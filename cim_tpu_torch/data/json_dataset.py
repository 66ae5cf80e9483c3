"""COCO-json dataset -> roidb (reference lib/datasets/json_dataset.py).

Each roidb entry carries:
  image (path), width, height, id, flipped,
  boxes (N, 4) float32       COB proposal boxes (xyxy)
  masks (N, S, S) float32    rasterized proposal masks (S = MASK_SIZE)
  gt_classes (1, C) int32    multi-hot image-level label (the weak label —
                             reference json_dataset.py:181,219-225)
  gt_boxes (G, 5) float32    [x1,y1,x2,y2,cls] (eval bookkeeping only)
  mat (N, C+1) float32       offline cluster assignment (PCL/AGPL)

Uses the in-repo COCO implementation (cim_tpu_torch.evaluation.coco) instead of
pycocotools; gt roidbs are pickle-cached keyed by mask size
(reference :128-150).
"""
from __future__ import annotations

import logging
import os
import pickle

import numpy as np

from cim_tpu_torch.data import catalog
from cim_tpu_torch.evaluation.coco import COCO

logger = logging.getLogger(__name__)


class JsonDataset:
    def __init__(self, cfg, name: str):
        self.cfg = cfg
        self.name = name
        spec = catalog.resolve(cfg, name)
        self.image_directory = spec[catalog.IM_DIR]
        self.image_prefix = spec.get(catalog.IM_PREFIX, "")
        self.devkit_dir = spec.get(catalog.DEVKIT_DIR)
        self.annotation_file = spec[catalog.ANN_FN]
        self.COCO = COCO(self.annotation_file)
        self.debug = cfg.DEBUG

        category_ids = self.COCO.getCatIds()
        self.classes = [
            c["name"] for c in self.COCO.loadCats(category_ids)
        ]
        self.num_classes = len(self.classes)
        self.json_category_id_to_contiguous_id = {
            v: i for i, v in enumerate(category_ids)
        }
        self.contiguous_category_id_to_json_id = {
            i: v for i, v in enumerate(category_ids)
        }
        self.mask_size = cfg.FAST_RCNN.MASK_SIZE

    @property
    def cache_path(self):
        path = os.path.join(self.cfg.DATA_DIR, "cache")
        os.makedirs(path, exist_ok=True)
        return path

    # ------------------------------------------------------------------ #
    def get_roidb(
        self,
        gt: bool = False,
        proposal_file: str | None = None,
        mat_file: str | None = None,
        proposal_limit: int = -1,
    ):
        image_ids = sorted(self.COCO.getImgIds())
        roidb = [dict(self.COCO.imgs[i]) for i in image_ids]
        if self.debug:
            roidb = roidb[:100]
        for entry in roidb:
            self._prep_roidb_entry(entry)

        if gt:
            cache_filepath = os.path.join(
                self.cache_path,
                f"{self.name}_gt_roidb_{self.mask_size}.pkl",
            )
            if os.path.exists(cache_filepath) and not self.debug:
                logger.info("Loading cached gt_roidb from %s", cache_filepath)
                with open(cache_filepath, "rb") as fp:
                    roidb = pickle.load(fp)
            else:
                for entry in roidb:
                    self._add_gt_annotations(entry)
                if not self.debug:
                    with open(cache_filepath, "wb") as fp:
                        pickle.dump(roidb, fp, pickle.HIGHEST_PROTOCOL)

        if mat_file is not None:
            self._add_mat_from_file(roidb, mat_file)
        if proposal_file is not None:
            self._add_proposals_from_file(roidb, proposal_file, proposal_limit)
        return roidb

    # ------------------------------------------------------------------ #
    def _prep_roidb_entry(self, entry):
        entry["dataset_name"] = self.name
        im_path = os.path.join(
            self.image_directory, self.image_prefix + entry.get("file_name", "")
        )
        entry["image"] = im_path
        entry["flipped"] = False
        entry["boxes"] = np.empty((0, 4), np.float32)
        entry["masks"] = np.empty(
            (0, self.mask_size, self.mask_size), np.float32
        )
        entry["gt_boxes"] = np.empty((0, 5), np.float32)
        entry["gt_classes"] = np.zeros((1, self.num_classes), np.int32)
        entry["mat"] = np.empty((0, self.num_classes + 1), np.float32)
        for k in ("date_captured", "url", "license", "file_name"):
            entry.pop(k, None)

    def _add_gt_annotations(self, entry):
        ann_ids = self.COCO.getAnnIds(imgIds=[entry["id"]])
        objs = self.COCO.loadAnns(ann_ids)
        height, width = entry["height"], entry["width"]
        for obj in objs:
            if obj.get("ignore", 0) == 1:
                continue
            x, y, w, h = obj["bbox"]
            x1 = np.clip(x, 0, width - 1)
            y1 = np.clip(y, 0, height - 1)
            x2 = np.clip(x + np.maximum(0, w - 1), 0, width - 1)
            y2 = np.clip(y + np.maximum(0, h - 1), 0, height - 1)
            if obj["area"] <= 0 or x2 <= x1 or y2 <= y1:
                continue
            cls = self.json_category_id_to_contiguous_id[obj["category_id"]]
            entry["gt_boxes"] = np.append(
                entry["gt_boxes"],
                np.array([[x1, y1, x2, y2, cls]], np.float32),
                axis=0,
            )
            entry["gt_classes"][0, cls] = 1

    def _add_proposals_from_file(self, roidb, proposal_file, top_k):
        logger.info("Loading proposals from: %s", proposal_file)
        with open(proposal_file, "rb") as f:
            proposals = pickle.load(f)
        id_field = "indexes" if "indexes" in proposals else "ids"
        _sort_by_id(proposals, id_field, ["boxes", id_field, "scores", "masks"])
        for i, entry in enumerate(roidb):
            if str(entry["id"]) != str(proposals[id_field][i]):
                raise AssertionError(
                    f"proposal id mismatch: {entry['id']} vs "
                    f"{proposals[id_field][i]} (reference "
                    "json_dataset.py:244-250 sanity check)"
                )
            boxes = np.asarray(proposals["boxes"][i], np.float32)
            boxes = _clip_boxes(boxes, entry["height"], entry["width"])
            if top_k > 0:
                boxes = boxes[:top_k]
            entry["boxes"] = np.append(entry["boxes"], boxes, axis=0)
            masks = np.asarray(proposals["masks"][i], np.float32)
            entry["masks"] = np.append(entry["masks"], masks, axis=0)

    def _add_mat_from_file(self, roidb, mat_file):
        logger.info("Loading label-assign mats from: %s", mat_file)
        with open(mat_file, "rb") as f:
            mats = pickle.load(f)
        id_field = "indexes" if "indexes" in mats else "ids"
        _sort_by_id(mats, id_field, ["mat", id_field])
        for i, entry in enumerate(roidb):
            if str(entry["id"]) != str(mats[id_field][i]):
                raise AssertionError("label-assign id mismatch")
            mat = np.asarray(mats["mat"][i], np.float32)
            entry["mat"] = np.append(entry["mat"], mat, axis=0)


def _clip_boxes(boxes, height, width):
    boxes[:, 0] = np.clip(boxes[:, 0], 0, width - 1)
    boxes[:, 1] = np.clip(boxes[:, 1], 0, height - 1)
    boxes[:, 2] = np.clip(boxes[:, 2], 0, width - 1)
    boxes[:, 3] = np.clip(boxes[:, 3], 0, height - 1)
    return boxes


def _sort_by_id(d, id_field, fields):
    order = np.argsort(np.asarray(d[id_field]))
    for k in fields:
        if k in d:
            d[k] = [d[k][i] for i in order]
