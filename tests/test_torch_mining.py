"""The port's CIM mining against cim_tpu's, on the CPU.

Same seeded inputs through cim_tpu.mining.cim (and cim_tpu.ops.nms) and
their counterparts in cim_tpu_torch. Integer and bool outputs (keep masks,
mined rows, labels, big-proposal flags) must agree exactly; float outputs
(mined weights, loss weights) are products of the same float32 scores and
must agree within rtol 1e-6. Inputs include padding rows, class budgets,
class-agnostic detector scores and scores quantized to a few levels, so
that the stable-sort, first-max and scatter-max tie rules are exercised.
Anti-noise sampling takes cim_tpu's own jax.random draws as injected
uniforms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cim_tpu.mining import cim as jcim
from cim_tpu.ops.nms import greedy_nms_from_iou as jax_nms
from cim_tpu_torch.mining import cim as tcim
from cim_tpu_torch.ops.nms import greedy_nms_from_iou

FLOAT_TOL = dict(rtol=1e-6, atol=0)


def _instance(rng, n=60, pad=8, c=20, n_labels=3, agnostic=False, quantize=False):
    """Realistic CIM inputs padded by ``pad`` rows: softmax-like scores and
    consistent IoU / containment matrices from random masks."""
    masks = rng.rand(n, 14, 14) > rng.uniform(0.4, 0.7)
    flat = masks.reshape(n, -1).astype(np.float64)
    inter = flat @ flat.T
    area = flat.sum(-1)
    iou = (inter / np.maximum(area[:, None] + area[None, :] - inter, 1)).astype(np.float32)
    asy = (inter / np.maximum(area[None, :], 1)).astype(np.float32)
    cls = rng.dirichlet(np.ones(c), size=n).astype(np.float32)
    if agnostic:
        det = rng.rand(n, 1).astype(np.float32)
        det /= det.sum()
    else:
        det = rng.dirichlet(np.ones(n), size=c).T.astype(np.float32).copy()
    if quantize:  # many exact ties in the scores
        cls = np.round(cls * 8) / 8
        det = np.round(det * 64) / 64
    labels = np.zeros(c, np.float32)
    labels[rng.choice(c, n_labels, replace=False)] = 1

    def rows(x):
        return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])

    def square(m):
        out = np.zeros((n + pad, n + pad), np.float32)
        out[:n, :n] = m
        return out

    valid = np.arange(n + pad) < n
    return rows(cls), rows(det), labels, square(iou), square(asy), valid


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _assert_mined(got, want):
    np.testing.assert_array_equal(got.gt_mask.numpy(), np.asarray(want.gt_mask))
    np.testing.assert_array_equal(got.asy_iou_flag.numpy(), np.asarray(want.asy_iou_flag))
    np.testing.assert_array_equal(got.gt_labels.numpy(), np.asarray(want.gt_labels))
    np.testing.assert_allclose(got.gt_weights.numpy(), np.asarray(want.gt_weights), **FLOAT_TOL)


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "ties"])
def test_greedy_nms_from_iou_matches_jax(quantize):
    """Five batched classes of 30 candidates, a third of them padding."""
    rng = np.random.RandomState(1)
    c, n = 5, 30
    iou = rng.rand(c, n, n).astype(np.float32)
    iou = (iou + iou.transpose(0, 2, 1)) / 2
    scores = rng.rand(c, n).astype(np.float32)
    if quantize:
        scores = np.round(scores * 4) / 4
    valid = rng.rand(c, n) > 0.3
    want = jax.vmap(lambda i, s, v: jax_nms(i, s, 0.5, valid=v))(*_j(iou, scores, valid))
    rounds = []
    got = greedy_nms_from_iou(*_t(iou, scores), 0.5, valid=torch.from_numpy(valid),
                              rounds=rounds)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(rounds) == 1 and rounds[0] >= 1
    assert not (got.numpy() & ~valid).any()


@pytest.mark.parametrize("budget", [0, 4])
@pytest.mark.parametrize("agnostic", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_cim_mine_matches_jax(seed, agnostic, budget):
    rng = np.random.RandomState(seed)
    cls, det, labels, iou, asy, valid = _instance(rng, agnostic=agnostic)
    params = dict(p_seed=0.1, cls_thr=0.25, iou_thr=0.5, con_thr=0.85, class_budget=budget)
    want = jcim.cim_mine(*_j(cls, det, labels, iou, asy, valid), jcim.MiningParams(**params))
    got = tcim.cim_mine(*_t(cls, det, labels, iou, asy, valid), tcim.MiningParams(**params))
    assert got.gt_mask.any()
    _assert_mined(got, want)


def test_cim_mine_ties_match_jax():
    rng = np.random.RandomState(7)
    cls, det, labels, iou, asy, valid = _instance(rng, n_labels=5, quantize=True)
    want = jcim.cim_mine(*_j(cls, det, labels, iou, asy, valid), jcim.MiningParams())
    got = tcim.cim_mine(*_t(cls, det, labels, iou, asy, valid), tcim.MiningParams())
    _assert_mined(got, want)


def test_cim_mine_chunks_classes_as_jax():
    """80 classes (COCO): the containment mining runs in class chunks."""
    rng = np.random.RandomState(3)
    cls, det, labels, iou, asy, valid = _instance(rng, c=80, n_labels=4)
    want = jcim.cim_mine(*_j(cls, det, labels, iou, asy, valid), jcim.MiningParams())
    got = tcim.cim_mine(*_t(cls, det, labels, iou, asy, valid), tcim.MiningParams())
    _assert_mined(got, want)


@pytest.mark.parametrize("budget", [0, 4])
@pytest.mark.parametrize("quantize", [False, True], ids=["float", "ties"])
def test_mist_mine_matches_jax(quantize, budget):
    rng = np.random.RandomState(4)
    cls, det, labels, iou, _, valid = _instance(rng, quantize=quantize)
    preds = cls * det
    params = dict(class_budget=budget)
    want = jcim.mist_mine(*_j(preds, labels, iou, valid), jcim.MiningParams(**params))
    got = tcim.mist_mine(*_t(preds, labels, iou, valid), tcim.MiningParams(**params))
    _assert_mined(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assign_pseudo_labels_matches_jax(seed):
    rng = np.random.RandomState(seed)
    cls, det, labels, iou, asy, valid = _instance(rng)
    params = dict(cls_thr=0.35, iou_thr=0.6)
    jp, tp = jcim.MiningParams(**params), tcim.MiningParams(**params)
    jm = jcim.cim_mine(*_j(cls, det, labels, iou, asy, valid), jp)
    tm = tcim.cim_mine(*_t(cls, det, labels, iou, asy, valid), tp)
    want = jcim.assign_pseudo_labels(jm, jnp.asarray(iou), jnp.asarray(valid), jp)
    got = tcim.assign_pseudo_labels(tm, *_t(iou, valid), tp)
    np.testing.assert_array_equal(got.pseudo_labels.numpy(), np.asarray(want.pseudo_labels))
    np.testing.assert_array_equal(got.pseudo_iou_labels.numpy(),
                                  np.asarray(want.pseudo_iou_labels))
    np.testing.assert_allclose(got.loss_weights.numpy(), np.asarray(want.loss_weights),
                               **FLOAT_TOL)
    assert bool(got.has_gt) == bool(want.has_gt)
    assert int(got.gt_count) == int(want.gt_count) > 0
    assert not got.pseudo_labels.numpy()[~valid].any()


def _uniforms(key, c, k_draw):
    """cim_tpu's draws: one uniform vector per class from split keys
    (cim_tpu/mining/cim.py anti_noise_resample)."""
    return np.array(jax.vmap(lambda k: jax.random.uniform(k, (k_draw,)))(
        jax.random.split(key, c)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_anti_noise_resample_matches_jax(seed):
    rng = np.random.RandomState(seed)
    cls, det, labels, iou, asy, valid = _instance(rng, n_labels=4)
    jm = jcim.cim_mine(*_j(cls, det, labels, iou, asy, valid), jcim.MiningParams())
    tm = tcim.cim_mine(*_t(cls, det, labels, iou, asy, valid), tcim.MiningParams())
    n, c = cls.shape
    k_draw = jcim.max_seeds(0.1, n)
    key = jax.random.PRNGKey(100 + seed)
    want = jcim.anti_noise_resample(jm, jnp.asarray(labels), key, max_draws=k_draw)
    got = tcim.anti_noise_resample(tm, torch.from_numpy(labels), max_draws=k_draw,
                                   uniforms=torch.from_numpy(_uniforms(key, c, k_draw)))
    _assert_mined(got, want)
    assert got.gt_mask.sum() <= tm.gt_mask.sum()


def test_anti_noise_resample_draws_from_generator():
    """Without injected uniforms the draws come from the generator: the
    same seed gives the same survivors."""
    rng = np.random.RandomState(5)
    cls, det, labels, iou, asy, valid = _instance(rng, n_labels=4)
    mined = tcim.cim_mine(*_t(cls, det, labels, iou, asy, valid), tcim.MiningParams())
    outs = [tcim.anti_noise_resample(mined, torch.from_numpy(labels),
                                     torch.Generator().manual_seed(9), max_draws=7).gt_mask
            for _ in range(2)]
    torch.testing.assert_close(outs[0], outs[1])
    assert (outs[0] <= mined.gt_mask).all()


@pytest.mark.parametrize("using_cim", [True, False])
def test_cim_layer_matches_jax(using_cim):
    """The full layer on (N, C+1) head outputs with anti-noise on."""
    rng = np.random.RandomState(11)
    cls, det, labels, iou, asy, valid = _instance(rng, n_labels=3)
    bg = np.full((cls.shape[0], 1), 0.05, np.float32)
    cls1, det1 = np.concatenate([bg, cls], 1), np.concatenate([bg, det], 1)
    params = dict(cls_thr=0.35, iou_thr=0.6, anti_noise=True)
    key = jax.random.PRNGKey(3)
    want = jcim.cim_layer(*_j(cls1, det1, labels, iou, asy, valid),
                          jcim.MiningParams(**params), key, using_cim=using_cim)
    k_draw = jcim.max_seeds(0.1, cls.shape[0])
    got = tcim.cim_layer(*_t(cls1, det1, labels, iou, asy, valid),
                         tcim.MiningParams(**params), using_cim=using_cim,
                         uniforms=torch.from_numpy(_uniforms(key, 20, k_draw)))
    np.testing.assert_array_equal(got.pseudo_labels.numpy(), np.asarray(want.pseudo_labels))
    np.testing.assert_array_equal(got.pseudo_iou_labels.numpy(),
                                  np.asarray(want.pseudo_iou_labels))
    np.testing.assert_allclose(got.loss_weights.numpy(), np.asarray(want.loss_weights),
                               **FLOAT_TOL)
    assert int(got.gt_count) == int(want.gt_count)
