"""CIM's four training losses (reference lib/modeling/heads.py:10-166) over
an image's valid proposals, and their assembly into the objective
(reference model_builder.py:161-207): branch 0 weighted 3, the iou loss
x 3, each branch gated on having mined anything.
"""
from __future__ import annotations

import torch

EPS = 1e-6


def _clamp01(x):
    return x.clamp(EPS, 1.0 - EPS)


def _bce(pred, target):
    pred = _clamp01(pred)
    return -(target * torch.log(pred) + (1.0 - target) * torch.log(1.0 - pred))


def _with_bg(labels):
    return torch.cat([torch.ones_like(labels[:1]), labels])


def mil_bag_loss(predict_cls, predict_det, labels):
    pred = _clamp01((predict_cls * predict_det).sum(dim=0, keepdim=True))
    return _bce(pred, _with_bg(labels)[None, :]).mean()


def _weighted_bag_loss(predict, pseudo, label_tmp, loss_weight):
    ind = (pseudo != 0).sum(dim=-1) != 0
    tmp = (pseudo != 0).to(predict.dtype)
    fg = ind[:, None] * predict * tmp
    aggression = _clamp01(fg.amax(dim=0) * label_tmp + predict.amax(dim=0) * (1.0 - label_tmp))
    agg_index = torch.where(label_tmp == 1, torch.argmax(fg, dim=0), torch.argmax(predict, dim=0))
    weight = torch.where(label_tmp == 1, loss_weight[agg_index], torch.ones_like(label_tmp))
    return (_bce(aggression, label_tmp) * weight).mean()


def cls_iou_loss(cls_score, iou_score, pseudo, pseudo_iou, loss_weights, labels):
    """(cls_loss, iou_loss, bag_loss) of one refine branch."""
    cls_score = _clamp01(cls_score)
    iou_score = _clamp01(iou_score)
    label_tmp = _with_bg(labels)
    ind = (pseudo != 0).sum(dim=-1) != 0
    bag = _weighted_bag_loss(cls_score * iou_score, pseudo, label_tmp, loss_weights)
    onehot = (pseudo != 0).to(cls_score.dtype) * ind[:, None]
    n_mined = onehot.sum()
    zero = torch.zeros((), dtype=cls_score.dtype, device=cls_score.device)
    ce = -onehot * torch.log(cls_score) * loss_weights[:, None]
    cls_loss = torch.where(n_mined > 0, ce.sum() / n_mined.clamp(min=1.0), zero)
    fg_ind = onehot[:, 1:].sum(dim=-1) != 0
    d = ((onehot * iou_score).sum(dim=-1) - pseudo_iou).abs()
    l1 = torch.where(d < 1.0, 0.5 * d * d, d - 0.5) * loss_weights * fg_ind
    n_fg = (onehot * fg_ind[:, None]).sum()
    iou_loss = torch.where(n_fg > 0, l1.sum() / n_fg.clamp(min=1.0), zero)
    return cls_loss, iou_loss, bag


def pcl_loss(predict_cls, mat, max_clusters=64):
    """PCL cluster loss (arXiv:1807.03342): mat (N, C+1) integer cluster
    ids (0 unassigned; the background cluster's id in column 0)."""
    mat = mat.to(torch.int32)
    pred = _clamp01(predict_cls)
    bg_ind = mat[:, 0].max()
    row_bce = _bce(pred, (mat != 0).to(pred.dtype)).mean(dim=1)
    cids = torch.arange(1, max_clusters + 1, dtype=torch.int32, device=mat.device)
    tf = mat[None, :, :] == cids[:, None, None]
    member = tf.any(dim=2).to(pred.dtype)
    count = member.sum(dim=1)
    present = count > 0
    col_ind = tf.any(dim=1).to(pred.dtype)
    mean_vec = (member @ pred) / count.clamp(min=1.0)[:, None]
    fg_loss = count * _bce(mean_vec, col_ind).mean(dim=1)
    bg_loss = member @ row_bce
    zero = torch.zeros_like(count)
    total = torch.where(present, torch.where(cids == bg_ind, bg_loss, fg_loss), zero).sum()
    return 12.0 * total / (1e-6 + torch.where(present, count, zero).sum())


def image_loss(out, labels, mat, pseudo, max_clusters=64):
    """The objective of one image given each branch's (pseudo, pseudo_iou,
    loss_weights, has_gt): (total, {bag_loss, pcl_loss, cls_loss,
    iou_loss})."""
    losses = {"bag_loss": mil_bag_loss(out["predict_cls"], out["predict_det"], labels),
              "pcl_loss": pcl_loss(out["predict_cls"], mat, max_clusters)}
    cls_l = iou_l = torch.zeros((), device=labels.device)
    for k, (pl, piou, lw, has_gt) in enumerate(pseudo):
        lmda = 3.0 if k == 0 else 1.0
        c_l, i_l, b_l = cls_iou_loss(out["refine_cls"][k], out["refine_iou"][k], pl, piou,
                                     lmda * lw, labels)
        gate = has_gt.float()
        cls_l = cls_l + gate * c_l
        iou_l = iou_l + gate * 3.0 * i_l
        losses["bag_loss"] = losses["bag_loss"] + gate * b_l
    losses["cls_loss"], losses["iou_loss"] = cls_l, iou_l
    return sum(losses.values()), losses
