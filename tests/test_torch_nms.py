"""The port's host post-processing against cim_tpu's: greedy NMS, soft-NMS,
per-class NMS with the detections limit, and the CorLoc argmax."""
import numpy as np
import pytest

from cim_tpu.config import get_default_cfg
from cim_tpu.engine import test as jax_test
from cim_tpu.ops import nms as jax_nms
from cim_tpu_torch.engine import test as torch_test
from cim_tpu_torch.ops import nms as torch_nms


def _dets(rng, n=60):
    """(n, 5) overlapping boxes in a 100x100 image with distinct scores."""
    x1 = rng.uniform(0, 70, n)
    y1 = rng.uniform(0, 70, n)
    boxes = np.stack([x1, y1, x1 + rng.uniform(5, 30, n), y1 + rng.uniform(5, 30, n)], -1)
    return np.hstack([boxes, rng.permutation(n)[:, None] / n + 0.01]).astype(np.float32)


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_nms_np_matches_jax(rng, thresh):
    dets = _dets(rng)
    keep = torch_nms.nms_np(dets, thresh)
    assert keep == list(jax_nms.nms_np(dets, thresh))
    assert 0 < len(keep) < len(dets)
    assert torch_nms.nms_np(dets[:0], thresh) == []


@pytest.mark.parametrize("method", ["hard", "linear", "gaussian"])
def test_soft_nms_np_matches_jax(rng, method):
    dets = _dets(rng)
    got, got_inds = torch_nms.soft_nms_np(dets, 0.5, 0.3, 0.001, method)
    want, want_inds = jax_nms.soft_nms_np(dets, 0.5, 0.3, 0.001, method)
    np.testing.assert_array_equal(got_inds, want_inds)
    np.testing.assert_array_equal(got, want)


def _cfg(soft_nms: bool, per_im: int):
    cfg = get_default_cfg()
    cfg.TEST.SOFT_NMS.ENABLED = soft_nms
    cfg.TEST.DETECTIONS_PER_IM = per_im
    return cfg


@pytest.mark.parametrize(
    "soft_nms, per_im", [(False, 100), (False, 20), (True, 100)],
    ids=["nms", "nms_limit20", "soft_nms"],
)
def test_box_results_with_nms_and_limit_matches_jax(rng, soft_nms, per_im):
    cfg = _cfg(soft_nms, per_im)
    boxes = _dets(rng)[:, :4]
    scores = rng.rand(len(boxes), cfg.MODEL.NUM_CLASSES).astype(np.float32) ** 3
    got = torch_test.box_results_with_nms_and_limit(cfg, scores, boxes)
    want = jax_test.box_results_with_nms_and_limit(cfg, scores, boxes)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert len(got[2]) == len(want[2]) == cfg.MODEL.NUM_CLASSES + 1
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g, w)
    assert sum(len(c) for c in got[2]) <= per_im


def test_box_results_for_corloc_matches_jax(rng):
    cfg = get_default_cfg()
    boxes = _dets(rng)[:, :4]
    scores = rng.rand(len(boxes), cfg.MODEL.NUM_CLASSES).astype(np.float32)
    got = torch_test.box_results_for_corloc(cfg, scores, boxes)
    want = jax_test.box_results_for_corloc(cfg, scores, boxes)
    for g, w in zip(got[:2] + tuple(got[2]), want[:2] + tuple(want[2])):
        np.testing.assert_array_equal(g, w)


def test_bbox_vote_not_ported(rng):
    cfg = get_default_cfg()
    cfg.TEST.BBOX_VOTE.ENABLED = True
    boxes = _dets(rng)[:, :4]
    with pytest.raises(NotImplementedError, match="BBOX_VOTE"):
        torch_test.box_results_with_nms_and_limit(
            cfg, np.ones((len(boxes), cfg.MODEL.NUM_CLASSES), np.float32), boxes
        )
