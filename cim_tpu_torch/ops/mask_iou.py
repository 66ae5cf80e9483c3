"""Mask IoU and asymmetric IoU of flattened 0/1 masks (port of
cim_tpu/ops/mask_iou.py).

    mask_iou(a, b)[i, j]            = |a_i ∩ b_j| / |a_i ∪ b_j|
    mask_asymmetric_iou(a, b)[i, j] = |a_i ∩ b_j| / |b_j|

with 0 where the divisor is 0. The intersections are one float32 product
of the flattened masks, as cim_tpu's XLA dot: the inputs are 0 or 1 and
the sums accumulate in float32, so every count below 2^24 pixels is exact
(also where TF32 is allowed: 0 and 1 are exact in it). The divisions take
a tensor divisor: on CUDA a Python-scalar divisor becomes a multiply by
its reciprocal, one ulp off. So the results are cim_tpu's bits.
"""
from __future__ import annotations

import torch


def _flatten(masks: torch.Tensor) -> torch.Tensor:
    return masks.reshape(masks.shape[0], -1).to(torch.float32)


def _inter_areas(masks_a, masks_b):
    a, b = _flatten(masks_a), _flatten(masks_b)
    return a @ b.T, a.sum(-1), b.sum(-1)


def _iou(inter, area_a, area_b):
    union = area_a[:, None] + area_b[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _asy(inter, area_b):
    area_b = area_b[None, :].expand_as(inter)
    return torch.where(area_b > 0, inter / area_b, torch.zeros_like(inter))


def mask_iou(masks_a: torch.Tensor, masks_b: torch.Tensor) -> torch.Tensor:
    """(N, H, W) x (K, H, W) bool or 0/1 masks -> (N, K) IoU, float32."""
    inter, area_a, area_b = _inter_areas(masks_a, masks_b)
    return _iou(inter, area_a, area_b)


def mask_asymmetric_iou(masks_a: torch.Tensor, masks_b: torch.Tensor) -> torch.Tensor:
    """(N, H, W) x (K, H, W) -> (N, K): |a_i ∩ b_j| / |b_j| ("a contains b")."""
    inter, _, area_b = _inter_areas(masks_a, masks_b)
    return _asy(inter, area_b)


def mask_iou_matrices(masks: torch.Tensor):
    """(iou, asy_iou) of (N, H, W) masks against themselves, from one
    product: what tools/pre/create_cob_iou stores for an image."""
    a = _flatten(masks)
    inter, area = a @ a.T, a.sum(-1)
    return _iou(inter, area, area), _asy(inter, area)
