"""CIM losses (port of cim_tpu/mining/losses.py).

Semantics: reference lib/modeling/heads.py:10-166 (PCL_loss,
loss_weight_bag_loss, cls_iou_loss, mil_bag_loss). Every function takes a
validity mask instead of boolean indexing, so shapes stay fixed; padding
rows contribute exact zeros to the loss and its gradient. Max reductions
use ``amax``, which splits the gradient among tied maxima as JAX's max
does.

Shapes:
  predict_*: (N, C+1) proposal scores (column 0 = background)
  labels:    (C,) multi-hot image-level labels
  pseudo_labels: (N, C+1) one-hot (all-zero rows = ignored proposals)
  valid:     (N,) bool proposal validity (padding mask)
"""
from __future__ import annotations

import torch

EPS = 1e-6


def _clamp01(x):
    return x.clamp(EPS, 1.0 - EPS)


def _bce(pred, target):
    pred = _clamp01(pred)
    return -(target * torch.log(pred) + (1.0 - target) * torch.log(1.0 - pred))


def smooth_l1(x, y):
    """torch.nn.functional.smooth_l1_loss(reduction='none'), beta=1, as
    cim_tpu spells it."""
    d = (x - y).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def _with_bg(labels):
    """[1, labels]: the background column is always "present"."""
    return torch.cat([torch.ones_like(labels[:1]), labels])


def mil_bag_loss(predict_cls, predict_det, labels, valid):
    """WSDDN bag loss (reference heads.py:149-166): pred[c] = sum over valid
    proposals of cls * det, BCE against [1, labels]."""
    pred = (predict_cls * predict_det * valid[:, None]).sum(dim=0, keepdim=True)
    pred = _clamp01(pred)
    return _bce(pred, _with_bg(labels)[None, :]).mean()


def loss_weight_bag_loss(predict, pseudo_labels, label_tmp, loss_weight, valid):
    """Weighted bag loss over mined foreground + unseen classes (reference
    heads.py:43-74). predict: (N, C+1); label_tmp: (C+1,) with bg = 1;
    loss_weight: (N,)."""
    predict = predict * valid[:, None]
    ind = (pseudo_labels != 0).sum(dim=-1) != 0  # (N,) mined rows
    tmp_pseudo = (pseudo_labels != 0).to(predict.dtype)

    fg_scores = ind[:, None] * predict * tmp_pseudo
    fg_agg_value = fg_scores.amax(dim=0)
    fg_agg_index = torch.argmax(fg_scores, dim=0)
    unseen_agg_value = predict.amax(dim=0)
    unseen_agg_index = torch.argmax(predict, dim=0)

    aggression = fg_agg_value * label_tmp + unseen_agg_value * (1.0 - label_tmp)
    aggression = _clamp01(aggression)

    label_flag = label_tmp == 1
    agg_index = torch.where(label_flag, fg_agg_index, unseen_agg_index)
    label_weight = torch.where(label_flag, loss_weight[agg_index],
                               torch.ones_like(label_tmp))
    return (_bce(aggression, label_tmp) * label_weight).mean()


def cls_iou_loss(cls_score, iou_score, pseudo_labels, pseudo_iou_labels,
                 loss_weights, labels, valid, del_iou_branch: bool = False):
    """Refinement-branch loss triple (reference heads.py:78-138). Returns
    (cls_loss, iou_loss, bag_loss). iou_score may be class-specific
    (N, C+1) or class-agnostic (N, 1)."""
    cls_score = _clamp01(cls_score)
    iou_score = _clamp01(iou_score)
    label_tmp = _with_bg(labels)

    ind = ((pseudo_labels != 0).sum(dim=-1) != 0) & valid  # mined rows

    if del_iou_branch:
        bag_score = cls_score
    elif iou_score.shape[-1] == 1:
        bag_score = torch.cat([cls_score[:, 0:1], cls_score[:, 1:] * iou_score], dim=1)
    else:
        bag_score = cls_score * iou_score
    bag_loss = loss_weight_bag_loss(bag_score, pseudo_labels, label_tmp, loss_weights, valid)

    onehot = (pseudo_labels != 0).to(cls_score.dtype) * ind[:, None]
    n_mined = onehot.sum()
    zero = torch.zeros((), dtype=cls_score.dtype, device=cls_score.device)

    # cls loss: weighted CE on mined rows
    ce = -onehot * torch.log(cls_score) * loss_weights[:, None]
    cls_loss = torch.where(n_mined > 0, ce.sum() / n_mined.clamp(min=1.0), zero)

    # iou loss: smooth-L1 on foreground-mined rows only
    fg_ind = onehot[:, 1:].sum(dim=-1) != 0
    if iou_score.shape[-1] == pseudo_labels.shape[-1]:
        fg_iou_score = (onehot * iou_score).sum(dim=-1)
    elif iou_score.shape[-1] == 1:
        fg_iou_score = iou_score[:, 0]
    else:
        raise NotImplementedError("Please check shape of fg_iou_score")
    l1 = smooth_l1(fg_iou_score, pseudo_iou_labels) * loss_weights * fg_ind
    n_fg = (onehot * fg_ind[:, None]).sum()
    iou_loss = torch.where(n_fg > 0, l1.sum() / n_fg.clamp(min=1.0), zero)
    return cls_loss, iou_loss, bag_loss


def pcl_loss(predict_cls, mat, labels, valid, max_clusters: int = 64):
    """PCL cluster loss (reference heads.py:10-41; arXiv:1807.03342).

    mat: (N, C+1) integer cluster-assignment matrix (0 = unassigned; the
    background cluster id sits in column 0). All cluster ids
    1..max_clusters are evaluated at once with presence masks (absent ids
    contribute zero), the per-cluster reductions as two float32 matmuls
    over a (K, N) membership matrix. Those stay exact float32: the port
    never lowers the float32 matmul precision.
    """
    del labels
    mat = mat.to(torch.int32) * valid[:, None].to(torch.int32)
    pred = _clamp01(predict_cls)

    # background cluster id: the unique nonzero value in column 0; 0 when
    # absent, which matches no cluster id below
    bg_ind = mat[:, 0].max()

    gt_tmp = (mat != 0).to(pred.dtype)
    row_bce = _bce(pred, gt_tmp.clamp(0, 1)).mean(dim=1)  # (N,)

    cids = torch.arange(1, max_clusters + 1, dtype=torch.int32, device=mat.device)
    tf = mat[None, :, :] == cids[:, None, None]  # (K, N, C+1)
    member = (tf.any(dim=2) & valid[None, :]).to(pred.dtype)  # (K, N)
    count = member.sum(dim=1)  # (K,)
    present = count > 0

    # foreground branch: mean prediction over members vs cluster classes
    col_ind = tf.any(dim=1).to(pred.dtype)  # (K, C+1)
    mean_vec = (member @ pred) / count.clamp(min=1.0)[:, None]
    fg_loss = count * _bce(mean_vec, col_ind.clamp(0, 1)).mean(dim=1)

    # background branch (== count * mean BCE over member rows)
    bg_loss = member @ row_bce  # (K,)

    zero = torch.zeros_like(count)
    contrib = torch.where(cids == bg_ind, bg_loss, fg_loss)
    total = torch.where(present, contrib, zero).sum()
    fg_bg_num = 1e-6 + torch.where(present, count, zero).sum()
    return 12.0 * total / fg_bg_num
