"""Dataset catalog: name -> paths (reference lib/datasets/dataset_catalog.py).

Paths are relative to cfg.DATA_DIR unless absolute.
"""
from __future__ import annotations

import os

IM_DIR = "image_directory"
ANN_FN = "annotation_file"
DEVKIT_DIR = "devkit_dir"
IM_PREFIX = "image_prefix"

DATASETS = {
    "voc_2012_trainaug": {
        IM_DIR: "VOC2012/JPEGImages",
        ANN_FN: "VOC2012/annotations/voc_2012_trainaug.json",
        DEVKIT_DIR: "VOC2012/VOCdevkit2012",
    },
    "voc_2012_sbdval": {
        IM_DIR: "VOC2012/JPEGImages",
        ANN_FN: "VOC2012/annotations/voc_2012_sbdval.json",
        DEVKIT_DIR: "VOC2012/VOCdevkit2012",
    },
    "coco_2017_train": {
        IM_DIR: "coco2017/train2017",
        ANN_FN: "coco2017/annotations/instances_train2017.json",
    },
    "coco_2017_val": {
        IM_DIR: "coco2017/val2017",
        ANN_FN: "coco2017/annotations/instances_val2017.json",
    },
    "coco_2017_test-dev": {
        IM_DIR: "coco2017/test2017",
        ANN_FN: "coco2017/annotations/image_info_test-dev2017.json",
    },
}


def resolve(cfg, name: str) -> dict:
    if name not in DATASETS:
        raise KeyError(f"Unknown dataset name: {name}")
    out = {}
    for k, v in DATASETS[name].items():
        out[k] = v if os.path.isabs(v) else os.path.join(cfg.DATA_DIR, v)
    return out


def register_dataset(name: str, spec: dict):
    DATASETS[name] = dict(spec)


def _load_registry_from_env():
    """Extra datasets from a JSON file named by CIM_TPU_DATASET_REGISTRY:
    {name: {image_directory, annotation_file[, devkit_dir]}}. Lets the
    CLIs consume custom datasets without code changes."""
    path = os.environ.get("CIM_TPU_DATASET_REGISTRY")
    if not path:
        return
    import json

    with open(path) as f:
        for name, spec in json.load(f).items():
            register_dataset(name, spec)


_load_registry_from_env()
