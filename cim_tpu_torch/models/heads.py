"""MIL + refinement heads (port of cim_tpu/models/heads.py).

Reference cls_iou_model (lib/modeling/heads.py:168-219): ``classifier``
-> softmax over classes, ``detector`` -> softmax over proposals, and K
refinement pairs ``refine_cls[k]`` (softmax) / ``refine_iou[k]``
(sigmoid). The proposal-axis softmax masks padding rows, which computes
the reference's distribution over the valid rows.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from cim_tpu_torch.models.layers import Linear

NEG = -1e30


def masked_softmax_over_proposals(logits, valid):
    """Softmax over the proposals of each image: logits (N, C+1) with
    valid (N,), or (B, N, C+1) with (B, N)."""
    return torch.softmax(logits.masked_fill(~valid[..., None], NEG), dim=-2)


class ClsIouHead(nn.Module):
    def __init__(self, dim_in: int, num_classes: int, refine_times: int = 3,
                 device=None):
        super().__init__()
        out = num_classes + 1
        self.classifier = Linear(dim_in, out, device=device)
        self.detector = Linear(dim_in, out, device=device)
        self.refine_cls = nn.ModuleList(
            Linear(dim_in, out, device=device) for _ in range(refine_times)
        )
        self.refine_iou = nn.ModuleList(
            Linear(dim_in, out, device=device) for _ in range(refine_times)
        )

    def forward(self, seg_x, valid):
        """seg_x: (N, D) float32; valid: (N,) bool. Returns (predict_cls,
        predict_det) (N, C+1) and (refine_cls, refine_iou) (K, N, C+1). A
        batch of images, seg_x (B, N, D) and valid (B, N), gains the
        leading axis: (B, N, C+1) and (B, K, N, C+1)."""
        predict_cls = torch.softmax(self.classifier(seg_x), dim=-1)
        predict_det = masked_softmax_over_proposals(self.detector(seg_x), valid)
        refine_cls = torch.stack([torch.softmax(m(seg_x), dim=-1) for m in self.refine_cls], dim=-3)
        refine_iou = torch.stack([torch.sigmoid(m(seg_x)) for m in self.refine_iou], dim=-3)
        return predict_cls, predict_det, refine_cls, refine_iou
