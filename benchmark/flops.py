"""The benchmark's own arithmetic of work: model FLOPs, RoIAlign taps and
bytes, and the card's published peaks.

Model FLOPs count the convolutions and matrix products of the plain
reference (``torch.utils.flop_counter`` over it on the meta device) at the
image's and proposals' true sizes, so padding counts as waste; the
backward counts only what autograd computes, so frozen stages
(FREEZE_AT) get no weight gradients; RoIAlign counts 2 C FLOPs a tap (a
tap: one of the four bilinear corners of one sample of one bin), once in
the forward and once in its backward. The count is the same whatever
implements a layer.
"""
from __future__ import annotations

import functools
import json
import os

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.bodies import conv_body
from benchmark.reference.model import CIMModel, ClsIouHead, MaskFuse

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


# the meta-device counts of earlier runs in this checkout, by shape: a count
# takes up to a second a shape, and set-up needs tens of them
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".cache", "flops.json")


def _cached(key: str, compute) -> float:
    try:
        with open(CACHE) as f:
            table = json.load(f)
    except (OSError, ValueError):
        table = {}
    if key not in table:
        table[key] = compute()
        os.makedirs(os.path.dirname(CACHE), exist_ok=True)
        tmp = f"{CACHE}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(table, f)
        os.replace(tmp, CACHE)
    return float(table[key])


def _count(fn) -> float:
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


@functools.lru_cache(maxsize=64)
def body_flops(body: str, h: int, w: int, train: bool, freeze_at: int = 2) -> float:
    """FLOPs of the conv body on an (h, w) image: the forward, and with
    ``train`` the backward of the stages above ``freeze_at``."""
    return _cached(f"body {body} {h} {w} {int(train)} {freeze_at}",
                   lambda: _body_flops(body, h, w, train, freeze_at))


def _body_flops(body, h, w, train, freeze_at):
    with torch.device("meta"):
        model = CIMModel(body, hidden=8)
    net = model.freeze(freeze_at).Conv_Body if train else model.Conv_Body

    def run():
        x = torch.zeros((1, 3, h, w), device="meta")
        if train:
            net(x).sum().backward()
        else:
            with torch.no_grad():
                net(x)

    return _count(run)


@functools.lru_cache(maxsize=16)
def head_flops_per_roi(dim_in: int, hidden: int, classes: int, refine: int,
                       train: bool) -> float:
    """FLOPs a proposal of MaskFuse after its RoIAlign (the 3x3 conv 2C ->
    C on 7x7, both FCs) and of the cls/iou heads; with ``train`` their
    backward too, into the RoIAlign output."""
    return _cached(f"head {dim_in} {hidden} {classes} {refine} {int(train)}",
                   lambda: _head_flops_per_roi(dim_in, hidden, classes, refine, train))


def _head_flops_per_roi(dim_in, hidden, classes, refine, train):
    n = 2
    with torch.device("meta"):
        head = MaskFuse(dim_in, 1.0 / 16, hidden)
        cls = ClsIouHead(hidden, classes, refine)

    def run():
        box_x = torch.zeros((n, 7, 7, dim_in), device="meta", requires_grad=train)
        x = torch.cat([box_x, box_x], dim=-1).permute(0, 3, 1, 2)
        x = head.mask_branch(x)
        x = head.seg_fc(x.reshape(n, -1))
        outs = cls(x)
        if train:
            sum(o.sum() for o in outs).backward()

    with torch.set_grad_enabled(train):
        return _count(run) / n


def roi_taps(rois: np.ndarray, spatial_scale: float, cap: int, r: int = 7) -> int:
    """Taps of RoIAlign over (N, 4) image-coordinate rois: bins x samples a
    bin (ceil(bin) an axis, capped at ``cap``) x 4 corners."""
    rois = np.asarray(rois, np.float32)
    if len(rois) == 0:
        return 0
    s, half = np.float32(spatial_scale), np.float32(0.5)
    bw = ((rois[:, 2] * s - half) - (rois[:, 0] * s - half)) / np.float32(r)
    bh = ((rois[:, 3] * s - half) - (rois[:, 1] * s - half)) / np.float32(r)
    gh = np.clip(np.ceil(bh), 1, cap)
    gw = np.clip(np.ceil(bw), 1, cap)
    return int((r * r * 4 * gh * gw).sum())


def least_seconds(n_bytes: float, flops: float) -> float:
    """The least time of a bf16 launch at the card's published peaks: the
    larger of its bytes over HBM bandwidth and its FLOPs over the bf16
    tensor-core rate."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def roi_fwd_least(valid_hws, channels: int, n_rois: int, taps: int, r: int = 7) -> float:
    """The least time of a RoIAlign forward over images' valid maps: each
    image's valid feature cells read once, its n_rois valid rois read and
    their (n_rois, r, r, C) output written once, 2 C FLOPs a tap. Padding
    rows and cells are waste, not work."""
    cells = sum(h * w for h, w in valid_hws)
    n_img = len(valid_hws)
    n_bytes = (cells * channels * BF16_BYTES + n_img * n_rois * 4 * 4
               + n_img * n_rois * r * r * channels * BF16_BYTES)
    return least_seconds(n_bytes, 2.0 * channels * taps)


def roi_bwd_least(map_hw, channels: int, n_rois: int, taps: int, r: int = 7) -> float:
    """The least time of a RoIAlign backward: the valid rois' (n_rois, r,
    r, C) output gradient and the rois read once, the gradient of the valid
    (h, w, C) map written once, 2 C FLOPs a tap."""
    n_bytes = (n_rois * r * r * channels * BF16_BYTES + n_rois * 4 * 4
               + map_hw[0] * map_hw[1] * channels * BF16_BYTES)
    return least_seconds(n_bytes, 2.0 * channels * taps)


def image_flops(body: str, hw, n_valid: int, rois_valid: np.ndarray, model_dims: dict,
                train: bool) -> float:
    """Model FLOPs of one image at its true (h, w) with its n_valid
    proposals (the rois of that pass, in its coordinates)."""
    cls = conv_body(body).Body
    dim_in = cls.dim_out
    head = head_flops_per_roi(dim_in, model_dims["hidden"], model_dims["classes"],
                              model_dims["refine"], train)
    taps = roi_taps(rois_valid, 1.0 / cls.stride, model_dims["cap"])
    return (body_flops(body, int(hw[0]), int(hw[1]), train, model_dims["freeze_at"])
            + n_valid * head + (2 if train else 1) * 2.0 * dim_in * taps)
