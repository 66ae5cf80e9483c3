"""The port's CIM losses against cim_tpu's, on the CPU in float32.

Same seeded scores, pseudo labels and cluster matrices through
cim_tpu.mining.losses and cim_tpu_torch.mining.losses, with padding rows.
Values and the gradients with respect to the scores must agree within
rtol 1e-5 (atol 1e-7): float32 sums in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cim_tpu.mining import losses as JL
from cim_tpu_torch.mining import losses as TL

TOL = dict(rtol=1e-5, atol=1e-7)
N, PAD, C = 40, 9, 20


def _case(seed):
    rng = np.random.RandomState(seed)
    n = N + PAD
    cls = rng.dirichlet(np.ones(C + 1), size=n).astype(np.float32)
    det = rng.dirichlet(np.ones(n), size=C + 1).T.astype(np.float32).copy()
    iou = rng.rand(n, C + 1).astype(np.float32)
    labels = np.zeros(C, np.float32)
    labels[rng.choice(C, 3, replace=False)] = 1
    present = np.concatenate([[0], np.nonzero(labels)[0] + 1])
    pl = np.zeros((n, C + 1), np.float32)
    for i in range(n):
        if rng.rand() < 0.5:
            pl[i, rng.choice(present)] = 1
    pil = (rng.rand(n) > 0.5).astype(np.float32)
    lw = rng.rand(n).astype(np.float32) * (pl.sum(-1) > 0)
    mat = np.zeros((n, C + 1), np.int32)
    for cid, c in enumerate(present[1:], start=1):
        mat[rng.choice(n, 6, replace=False), c] = cid
    mat[rng.choice(n, 6, replace=False), 0] = len(present)
    valid = np.arange(n) < N
    return cls, det, iou, labels, pl, pil, lw, mat, valid


def _both(jfn, tfn, diff, fixed):
    """Value and gradient (w.r.t. the ``diff`` arrays) of jfn vs tfn."""
    want, jgrads = jax.value_and_grad(
        lambda *d: jfn(*d, *[jnp.asarray(f) for f in fixed]), argnums=tuple(range(len(diff)))
    )(*[jnp.asarray(d) for d in diff])
    tdiff = [torch.from_numpy(d).requires_grad_() for d in diff]
    got = tfn(*tdiff, *[torch.from_numpy(np.asarray(f)) for f in fixed])
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    for t, g in zip(tdiff, jgrads):
        tg = torch.zeros_like(t) if t.grad is None else t.grad  # unused input
        np.testing.assert_allclose(tg.numpy(), np.asarray(g), **TOL)
    return got.item()


@pytest.mark.parametrize("seed", [0, 1])
def test_mil_bag_loss_matches_jax(seed):
    cls, det, _, labels, *_, valid = _case(seed)
    _both(JL.mil_bag_loss, TL.mil_bag_loss, [cls, det], [labels, valid])


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_weight_bag_loss_matches_jax(seed):
    cls, _, _, labels, pl, _, lw, _, valid = _case(seed)
    label_tmp = np.concatenate([[1.0], labels]).astype(np.float32)
    _both(JL.loss_weight_bag_loss, TL.loss_weight_bag_loss, [cls], [pl, label_tmp, lw, valid])


@pytest.mark.parametrize("part", [0, 1, 2], ids=["cls", "iou", "bag"])
@pytest.mark.parametrize("agnostic", [False, True])
def test_cls_iou_loss_matches_jax(agnostic, part):
    cls, _, iou, labels, pl, pil, lw, _, valid = _case(2)
    if agnostic:
        iou = np.ascontiguousarray(iou[:, :1])
    value = _both(lambda *a: JL.cls_iou_loss(*a)[part], lambda *a: TL.cls_iou_loss(*a)[part],
                  [cls, iou], [pl, pil, lw, labels, valid])
    assert value > 0


def test_cls_iou_loss_without_mined_rows_is_zero():
    cls, _, iou, labels, pl, pil, lw, _, valid = _case(3)
    args = [torch.from_numpy(x) for x in (cls, iou, np.zeros_like(pl), pil, lw, labels, valid)]
    cls_l, iou_l, _ = TL.cls_iou_loss(*args)
    assert cls_l.item() == 0.0 and iou_l.item() == 0.0


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("max_clusters", [8, 64])
def test_pcl_loss_matches_jax(seed, max_clusters):
    cls, *_, labels, _, _, _, mat, valid = _case(seed)
    value = _both(lambda p, m, lab, v: JL.pcl_loss(p, m, lab, v, max_clusters=max_clusters),
                  lambda p, m, lab, v: TL.pcl_loss(p, m, lab, v, max_clusters=max_clusters),
                  [cls], [mat, labels, valid])
    assert value > 0


def test_padding_rows_get_zero_gradient():
    """Whatever padding rows hold, they add nothing to any loss or grad."""
    cls, det, iou, labels, pl, pil, lw, mat, valid = _case(4)
    cls_t = torch.from_numpy(cls).requires_grad_()
    det_t = torch.from_numpy(det).requires_grad_()
    iou_t = torch.from_numpy(iou).requires_grad_()
    pl[~valid] = 0
    args = [torch.from_numpy(x) for x in (pl, pil, lw, labels, valid)]
    total = (TL.mil_bag_loss(cls_t, det_t, args[3], args[4])
             + sum(TL.cls_iou_loss(cls_t, iou_t, *args))
             + TL.pcl_loss(cls_t, torch.from_numpy(mat), args[3], args[4]))
    total.backward()
    for t in (cls_t, det_t, iou_t):
        assert not t.grad[~torch.from_numpy(valid)].any()
