"""Box geometry needed by the eval path (port of cim_tpu/ops/boxes.py)."""
from __future__ import annotations

import torch


def flip_boxes(boxes: torch.Tensor, im_width) -> torch.Tensor:
    """Horizontal flip of xyxy boxes (reference lib/utils/boxes.py
    flip_boxes): x1' = W - x2 - 1, x2' = W - x1 - 1."""
    x1 = im_width - boxes[..., 2] - 1
    x2 = im_width - boxes[..., 0] - 1
    return torch.stack([x1, boxes[..., 1], x2, boxes[..., 3]], dim=-1)
