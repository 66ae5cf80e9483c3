"""Detectron-pickle weights (reference lib/utils/detectron_weight_helper.py).

A Detectron pickle holds ``{"blobs": {name: array}}`` (or the bare dict).
Every CIM module's ``detectron_weight_mapping`` is the identity
(cim_tpu/utils/torch_weights.py load_detectron_pkl), so the blobs are
keyed by the model's own parameter and buffer names, which the port keeps.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np
import torch


def load_detectron_pkl(path_or_blobs) -> Dict[str, torch.Tensor]:
    """A Detectron pickle (a path, or its loaded dict) -> a state_dict of
    float32 CPU tensors, with any ``module.`` prefix of a DataParallel
    save removed."""
    if isinstance(path_or_blobs, (str, bytes, os.PathLike)):
        with open(path_or_blobs, "rb") as f:
            blobs = pickle.load(f, encoding="latin1")
    else:
        blobs = path_or_blobs
    blobs = blobs.get("blobs", blobs)
    return {k.replace("module.", ""): torch.from_numpy(np.array(v, np.float32))
            for k, v in blobs.items()}
