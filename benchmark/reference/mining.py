"""CIM pseudo-label mining (reference lib/modeling/heads.py CIM_layer) in
plain PyTorch, over the image's valid proposals only.

Per refine branch k: seeds are the top ceil(p_seed * N) proposals of each
class by class score; greedy mask-IoU NMS at cls_thr keeps some of them;
each kept seed contributes the proposal that contains it (asymmetric IoU
above con_thr, not a "big" proposal) with the highest detector score; a
proposal mined by several classes goes to the highest-scoring one
(lowest class index among ties); anti-noise sampling keeps the union of
n_c weighted draws with replacement per class; every proposal then takes
the label of the mined proposal it overlaps most (background below
cls_thr, ignored at no overlap), and a binary IoU target at iou_thr.

The anti-noise draws are the program's own stream, taken from the seed as
it takes them: torch.rand of shape (C, ceil(p_seed * N_pad)) from a
generator seeded with derive_seed(...), N_pad the proposal bucket of the
input, so both sides draw the same uniforms.
"""
from __future__ import annotations

import hashlib
import math

import numpy as np
import torch
import torch.nn.functional as F

NEG = -1e30


def derive_seed(*parts: int) -> int:
    digest = hashlib.sha256(repr(tuple(int(p) for p in parts)).encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def greedy_nms(iou, scores, thresh):
    """Greedy NMS by descending score (ties by index), batched over the
    leading axis, on the host: a candidate is kept iff no kept
    higher-ranked candidate overlaps it at iou >= thresh (float32)."""
    order = torch.sort(-scores, dim=-1, stable=True).indices.cpu().numpy()
    ov = (iou >= thresh).cpu().numpy()
    kept = np.zeros(scores.shape, bool)
    for b in range(scores.shape[0]):
        alive = np.ones(scores.shape[-1], bool)
        for j in order[b]:
            if alive[j]:
                kept[b, j] = True
                alive &= ~ov[b, j]
    return torch.from_numpy(kept).to(scores.device)


def _winner(eligible, scores_cn, c1):
    cand = torch.where(eligible, scores_cn, torch.full_like(scores_cn, NEG))
    winner = torch.argmax(cand, dim=0)
    mined = eligible.any(dim=0)
    best = cand.amax(dim=0)
    labels = F.one_hot(winner + 1, c1).float() * mined[:, None].float()
    weights = torch.where(mined, best, torch.full_like(best, -1.0))
    return labels, weights, mined


def mine_branch(cls_scores, det_scores, labels, iou_map, asy_map, n_pad, k, cfg, generator):
    """One branch's pseudo labels. cls_scores / det_scores (N, C+1) of the
    valid proposals; labels (C,); iou_map / asy_map (N, N) float32. Returns
    (pseudo_labels (N, C+1), pseudo_iou (N,), loss_weights (N,), has_gt)."""
    cls_thr = 0.25 + cfg["step_rate"] * k
    iou_thr = 0.5 + cfg["step_rate"] * k
    p_cls, p_det = cls_scores[:, 1:], det_scores[:, 1:]
    n, c = p_cls.shape
    n_f = torch.tensor(float(n), dtype=torch.float32)
    keep_count = int(torch.ceil(torch.tensor(cfg["p_seed"], dtype=torch.float32) * n_f).item())
    preds = p_cls * p_det
    # a "big" proposal contains 90 % or more of the proposals
    row_ok = ((asy_map > cfg["adj_thr"]).float().sum(-1) < 0.9 * n_f.to(asy_map.device))

    # seeds and NMS for every class
    seed_idx = torch.sort(-p_cls.T, dim=-1, stable=True).indices[:, :keep_count]  # (C, K)
    iou_seed = iou_map[seed_idx[:, :, None], seed_idx[:, None, :]]
    seed_scores = torch.gather(p_cls.T, 1, seed_idx)
    keep_seed = greedy_nms(iou_seed, seed_scores, cls_thr)

    # containment: the detector argmax among rows containing each kept seed
    mined = torch.zeros((c, n), dtype=torch.bool, device=p_cls.device)
    for ci in range(c):
        cols = seed_idx[ci][keep_seed[ci]]
        if cols.numel() == 0:
            continue
        contain = (asy_map[:, cols] > cfg["adj_thr"]) & row_ok[:, None]  # (N, K')
        has = contain.any(dim=0)
        cand = torch.where(contain, p_det[:, ci:ci + 1].expand_as(contain),
                           torch.full_like(contain, NEG, dtype=p_det.dtype))
        arg = torch.argmax(cand, dim=0)
        mined[ci, arg[has]] = True
    eligible = mined & (labels > 0)[:, None]
    gt_labels, gt_weights, gt_mask = _winner(eligible, preds.T, c + 1)

    if cfg["anti_noise"]:
        gt_labels, gt_weights, gt_mask = _anti_noise(gt_labels, gt_weights, gt_mask, labels,
                                                     n_pad, cfg, generator)
    return _assign(gt_labels, gt_weights, gt_mask, row_ok, iou_map, cls_thr, iou_thr)


def _anti_noise(gt_labels, weights, gt_mask, labels, n_pad, cfg, generator):
    n, c1 = gt_labels.shape
    c = c1 - 1
    k_draw = min(int(math.ceil(cfg["p_seed"] * n_pad)), n_pad)
    members = (gt_labels[:, 1:] == 1).T & (labels > 0)[:, None]  # (C, N)
    n_c = members.sum(dim=1)
    pos = members & (weights > 0)[None, :]
    w_pos = torch.where(pos, weights[None, :], torch.zeros_like(weights)[None, :])
    mem_f = members.float()
    p = torch.where(pos.any(dim=1, keepdim=True),
                    w_pos / w_pos.sum(dim=1, keepdim=True).clamp(min=1e-20),
                    mem_f / mem_f.sum(dim=1, keepdim=True).clamp(min=1.0))
    cdf = torch.cumsum(p, dim=1)
    u = torch.rand((c, k_draw), generator=generator, device=generator.device,
                   dtype=torch.float32).to(cdf.device)
    keep = torch.zeros(n, dtype=torch.bool, device=cdf.device)
    for ci in range(c):
        draws = u[ci, :int(n_c[ci])]
        if draws.numel() == 0:
            continue
        # draw t lands on the first row whose cdf reaches it; one beyond the
        # last lands on the bucket's last row: padding unless n fills it
        rows = torch.searchsorted(cdf[ci].contiguous(), draws.contiguous())
        keep[rows.clamp(max=n - 1) if n == n_pad else rows[rows < n]] = True
    keep |= ~members.any(dim=0)
    gt_mask = gt_mask & keep
    gt_labels = gt_labels * gt_mask[:, None]
    weights = torch.where(gt_mask, weights, torch.full_like(weights, -1.0))
    return gt_labels, weights, gt_mask


def _assign(gt_labels, gt_weights, gt_mask, row_ok, iou_map, cls_thr, iou_thr):
    c1 = gt_labels.shape[1]
    ov = torch.where(gt_mask[None, :], iou_map, torch.full_like(iou_map, -1.0))
    max_v = ov.amax(dim=-1)
    arg = torch.argmax(ov, dim=-1)
    pseudo = gt_labels[arg]
    weights = gt_weights[arg]
    ignore = max_v <= 0.0
    pseudo = torch.where(ignore[:, None], torch.zeros_like(pseudo), pseudo)
    weights = torch.where(ignore, torch.zeros_like(weights), weights)
    bg = ((max_v < cls_thr) & ~ignore) | ~row_ok
    bg_row = torch.zeros(c1, device=pseudo.device)
    bg_row[0] = 1.0
    pseudo = torch.where(bg[:, None], bg_row[None, :], pseudo)
    pseudo_iou = (max_v.clamp(min=0.0) > iou_thr).float()
    return pseudo, pseudo_iou, weights, gt_mask.any()
