"""roidb assembly: dataset concat, flip augmentation, filtering
(reference lib/datasets/roidb.py:33-196).
"""
from __future__ import annotations

import logging

import numpy as np

from cim_tpu_torch.data.json_dataset import JsonDataset

logger = logging.getLogger(__name__)


def combined_roidb_for_training(cfg, dataset_names=None, proposal_files=None,
                                mat_files=None):
    """Load + combine roidbs for training with flip augmentation
    (reference combined_roidb_for_training, roidb.py:33-71)."""
    dataset_names = dataset_names or cfg.TRAIN.DATASETS
    proposal_files = proposal_files or cfg.TRAIN.PROPOSAL_FILES
    mat_files = mat_files or cfg.TRAIN.REFINE_FILES
    if isinstance(dataset_names, str):
        dataset_names = (dataset_names,)

    roidbs = []
    for i, name in enumerate(dataset_names):
        ds = JsonDataset(cfg, name)
        pf = proposal_files[i] if i < len(proposal_files) else None
        mf = mat_files[i] if i < len(mat_files) else None
        roidb = ds.get_roidb(gt=True, proposal_file=pf, mat_file=mf)
        if cfg.TRAIN.USE_FLIPPED:
            logger.info("Appending horizontally-flipped training examples...")
            extend_with_flipped_entries(roidb)
        roidbs.append(roidb)

    roidb = [e for r in roidbs for e in r]
    roidb = filter_for_training(roidb)
    ratio_list, ratio_index = rank_for_training(roidb)
    logger.info("Loaded dataset: %d entries", len(roidb))
    return roidb, ratio_list, ratio_index


def extend_with_flipped_entries(roidb):
    """Flip boxes (x1' = W - x2 - 1), gt_boxes and masks
    (np.flip(masks, 2), reference roidb.py:74-115)."""
    flipped = []
    for entry in roidb:
        width = entry["width"]
        boxes = entry["boxes"].copy()
        oldx1 = boxes[:, 0].copy()
        oldx2 = boxes[:, 2].copy()
        boxes[:, 0] = width - oldx2 - 1
        boxes[:, 2] = width - oldx1 - 1
        assert (boxes[:, 2] >= boxes[:, 0]).all()

        gt_boxes = entry["gt_boxes"].copy()
        if len(gt_boxes):
            gx1 = gt_boxes[:, 0].copy()
            gx2 = gt_boxes[:, 2].copy()
            gt_boxes[:, 0] = width - gx2 - 1
            gt_boxes[:, 2] = width - gx1 - 1

        fe = {
            k: v
            for k, v in entry.items()
            if k not in ("boxes", "gt_boxes", "masks", "flipped")
        }
        fe["boxes"] = boxes
        fe["gt_boxes"] = gt_boxes
        fe["masks"] = np.flip(entry["masks"], 2).copy()
        fe["flipped"] = True
        flipped.append(fe)
    roidb.extend(flipped)


def filter_for_training(roidb):
    """Keep entries with at least one positive image-level class
    (reference filter_for_training, roidb.py:118-133)."""

    def is_valid(entry):
        return np.sum(entry["gt_classes"]) > 0

    num = len(roidb)
    filtered = [e for e in roidb if is_valid(e)]
    logger.info(
        "Filtered %d roidb entries: %d -> %d", num - len(filtered), num,
        len(filtered),
    )
    return filtered


def rank_for_training(roidb):
    """Aspect-ratio list for grouped batching (reference rank_for_training,
    roidb.py:136-196; with IMS_PER_BATCH=1 this is bookkeeping only)."""
    ratio_list = []
    for entry in roidb:
        ratio_list.append(entry["width"] / float(entry["height"]))
    ratio_list = np.array(ratio_list)
    ratio_index = np.argsort(ratio_list)
    return ratio_list[ratio_index], ratio_index
