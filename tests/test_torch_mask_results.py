"""The port's host post-processing against cim_tpu's, on the same inputs.

- evaluation.mask_results.mask_results_with_nms_and_limit_get_index
  against cim_tpu.evaluation.mask_results' over seeds and
  detections_per_im in {0, 5, 100}, with scores on a coarse grid so that
  the top-K threshold falls on ties (the `>=` rule) and the flat outputs
  leave out the last class (the reference's range(1, num_classes)):
  arrays and proposal indices exactly equal.
- engine.test.box_results_with_nms_and_limit with TEST.BBOX_VOTE on
  (scoring ID and the others) against cim_tpu.engine.test's, and
  ops.boxes.box_voting_np / box_iou_np against cim_tpu.ops.boxes': box
  coordinates within rtol 1e-6 (cim_tpu's IoU is jnp float32, the port's
  numpy float32), shapes and kept rows exact.
- parallel.eval_index_range / merge_sharded_results against
  cim_tpu.parallel's with the process index and count given.
"""
import numpy as np
import pytest

from cim_tpu import parallel as jax_parallel
from cim_tpu.config import get_default_cfg as jax_default_cfg
from cim_tpu.engine import test as jax_test
from cim_tpu.evaluation import mask_results as jax_mask_results
from cim_tpu.ops import boxes as jax_boxes
from cim_tpu_torch import parallel
from cim_tpu_torch.config import get_default_cfg
from cim_tpu_torch.engine import test as torch_test
from cim_tpu_torch.evaluation import mask_results
from cim_tpu_torch.ops import boxes

SCORING = ["ID", "TEMP_AVG", "AVG", "IOU_AVG", "GENERALIZED_AVG", "QUASI_SUM"]


def _case(seed, n=80, num_classes=20):
    """Clustered boxes (so NMS and voting have overlaps to act on) and
    scores on a 0.01 grid (ties across classes)."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(20, 180, (8, 2))
    c = centers[rng.randint(0, 8, n)] + rng.randn(n, 2) * 4
    wh = rng.uniform(10, 60, (n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    scores = np.round(rng.rand(n, num_classes) ** 3, 2).astype(np.float32)
    return scores, boxes


def _cfgs(detections_per_im, vote=None):
    out = []
    for cfg in (jax_default_cfg(), get_default_cfg()):
        cfg.TEST.DETECTIONS_PER_IM = detections_per_im
        cfg.TEST.SCORE_THRESH = 0.05
        if vote is not None:
            cfg.TEST.BBOX_VOTE.ENABLED = True
            cfg.TEST.BBOX_VOTE.SCORING_METHOD = vote
        out.append(cfg)
    return out


@pytest.mark.parametrize("detections_per_im", [0, 5, 100])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_results_get_index_matches_cim_tpu(seed, detections_per_im):
    scores, boxes_ = _case(seed)
    jcfg, tcfg = _cfgs(detections_per_im)
    want = jax_mask_results.mask_results_with_nms_and_limit_get_index(
        jcfg, scores, boxes_, detections_per_im)
    got = mask_results.mask_results_with_nms_and_limit_get_index(
        tcfg, scores, boxes_, detections_per_im)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert len(got[2]) == len(want[2]) == 21 and len(got[3]) == len(want[3]) == 21
    kept = 0
    for g, w, gi, wi in zip(got[2], want[2], got[3], want[3]):
        assert g.dtype == w.dtype and gi.dtype == wi.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(gi, wi)
        kept += len(gi)
    if detections_per_im:
        # the cap binds, and a tie at the threshold may keep more
        assert kept >= detections_per_im
    # the flat outputs stack classes 1..C-1: the last class is left out
    assert len(got[0]) == kept - len(got[3][20])


def test_mask_results_with_masks_matches_cim_tpu():
    scores, boxes_ = _case(4)
    masks = np.random.RandomState(4).rand(len(scores), 7, 7) > 0.5
    jcfg, tcfg = _cfgs(100)
    want = jax_mask_results.mask_results_with_nms_and_limit(jcfg, scores, boxes_, masks)
    got = mask_results.mask_results_with_nms_and_limit(tcfg, scores, boxes_, masks)
    for g, w in zip(got[3], want[3]):
        np.testing.assert_array_equal(g, w)
    m = (np.random.RandomState(5).rand(30, 40) > 0.5).astype(np.uint8)
    assert mask_results.coco_encode(m) == jax_mask_results.coco_encode(m)


@pytest.mark.parametrize("legacy", [True, False])
def test_box_iou_np_matches_cim_tpu(legacy):
    _, a = _case(6, n=30)
    _, b = _case(7, n=40)
    want = np.asarray(jax_boxes.box_iou(a, b, legacy))
    got = boxes.box_iou_np(a, b, legacy)
    assert got.dtype == np.float32 and got.shape == (30, 40)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("method", SCORING)
def test_box_voting_matches_cim_tpu(method):
    scores, boxes_ = _case(8)
    dets = np.hstack([boxes_, scores[:, :1]]).astype(np.float32)
    dets = dets[dets[:, 4] > 0.05]
    top = dets[::3]
    want = jax_boxes.box_voting_np(top, dets, 0.5, scoring_method=method)
    got = boxes.box_voting_np(top, dets, 0.5, scoring_method=method)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert not np.array_equal(got[:, :4], top[:, :4])  # the votes moved boxes


@pytest.mark.parametrize("detections_per_im", [0, 5, 100])
@pytest.mark.parametrize("method", ["ID", "TEMP_AVG"])
@pytest.mark.parametrize("seed", [0, 3])
def test_box_results_with_bbox_vote_matches_cim_tpu(seed, method, detections_per_im):
    scores, boxes_ = _case(seed)
    jcfg, tcfg = _cfgs(detections_per_im, vote=method)
    want = jax_test.box_results_with_nms_and_limit(jcfg, scores, boxes_)
    got = torch_test.box_results_with_nms_and_limit(tcfg, scores, boxes_)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=0)
    for g, w in zip(got[2], want[2]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
    if detections_per_im != 5:  # the top 5 may all stand alone
        _, _, plain = torch_test.box_results_with_nms_and_limit(_cfgs(detections_per_im)[1],
                                                                 scores, boxes_)
        assert any(not np.array_equal(g[:, :4], p[:, :4]) for g, p in zip(got[2], plain)
                   if len(p)), "voting moved no box"


@pytest.mark.parametrize("count", [1, 2, 3, 7])
@pytest.mark.parametrize("n", [0, 5, 16])
def test_eval_index_range_matches_cim_tpu(n, count):
    got = [parallel.eval_index_range(n, i, count) for i in range(count)]
    assert got == [jax_parallel.eval_index_range(n, i, count) for i in range(count)]
    assert got[0][0] == 0 and got[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


def test_merge_sharded_results_matches_cim_tpu():
    shards = [{"a": 1, "b": 2}, {}, {"c": 3, "a": 4}]
    assert parallel.merge_sharded_results(shards) == jax_parallel.merge_sharded_results(shards)
