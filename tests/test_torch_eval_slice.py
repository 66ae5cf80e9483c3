"""The port's eval slice against cim_tpu's, on the CPU in float32.

Both packages run run_inference (TPU.EVAL_BATCH = 1, fused TTA with
hflip, one extra scale and its hflip, then identity: 4 passes) over the
same 3-image synthetic COCO-json dataset, with one flax init driving both
models (tests/torch_parity.py). Each run's detections.pkl records hold
its Evaluator.im_detect_all scores per image. Score bounds are those of
tests/test_full_pipeline_parity.py's TTA test (rtol 2e-3, atol 2e-5).
"""
import os

import numpy as np
import pytest

from cim_tpu.config import clone_cfg
from cim_tpu.data import catalog
from cim_tpu.data.synthetic import write_synthetic_coco_dataset
from cim_tpu.engine import test as jax_test
from cim_tpu.engine import test_engine as jax_engine
from cim_tpu.models.builder import build_model as build_jax_model
from cim_tpu_torch.data import catalog as torch_catalog
from cim_tpu_torch.engine import test as torch_test
from cim_tpu_torch.engine import test_engine as torch_engine
from tests.torch_parity import init_variables, random_rois, small_cfg, torch_model

IMAGE_HW = (72, 96)
N_PROPS = 40
SCORE_TOL = dict(rtol=2e-3, atol=2e-5)


def _image_loader(entry):
    r = np.random.RandomState(entry["id"])
    return r.randint(0, 256, (entry["height"], entry["width"], 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_eval_slice")
    _, props = write_synthetic_coco_dataset(
        str(tmp), 3, N_PROPS, np.random.RandomState(4), image_hw=IMAGE_HW
    )
    for cat in (catalog, torch_catalog):  # each package has its own catalog
        cat.register_dataset("torch_eval_slice", {
            cat.IM_DIR: str(tmp), cat.ANN_FN: str(tmp / "ann.json"),
        })
    cfg = small_cfg(from_yaml=True)
    cfg.DATA_DIR = str(tmp)
    cfg.TEST.DATASETS = ("torch_eval_slice",)
    cfg.TEST.PROPOSAL_FILES = (props,)
    cfg.TEST.SCALE = IMAGE_HW[1]
    cfg.TEST.BBOX_AUG.SCALES = (128,)
    cfg.TPU.EVAL_BATCH = 1
    assert len(torch_test.Evaluator.tta_pass_list(cfg)) == 4

    variables = init_variables(cfg, seed=1)
    want = jax_engine.run_inference(
        cfg, build_jax_model(cfg), variables, str(tmp / "jax"),
        image_loader=_image_loader,
    )
    model = torch_model(cfg, variables)
    got = torch_engine.run_inference(
        cfg, model, str(tmp / "torch"), image_loader=_image_loader, device="cpu",
    )
    return cfg, model, variables, want, got


def test_im_detect_all_matches_jax(runs):
    """Per-image TTA scores: the port's detections.pkl records are its
    Evaluator.im_detect_all outputs, as cim_tpu's are."""
    cfg, _, _, (_, _, jax_scores), (_, _, torch_scores) = runs
    roidb, _, _, _, _ = torch_engine.get_roidb_and_dataset(
        cfg, cfg.TEST.DATASETS[0], cfg.TEST.PROPOSAL_FILES[0]
    )
    entry = roidb[0]
    scores = torch_scores[entry["image"]]["scores"]
    boxes = torch_scores[entry["image"]]["boxes"]
    want = jax_scores[entry["image"]]["scores"]
    assert scores.shape == want.shape == (N_PROPS, 20)
    assert np.isfinite(scores).all() and scores.std() > 0
    np.testing.assert_allclose(scores, want, **SCORE_TOL)
    np.testing.assert_array_equal(boxes, entry["boxes"])

    # NMS + limit keep the same detections from both score sets
    _, _, cls_got = torch_test.box_results_with_nms_and_limit(cfg, scores, boxes)
    _, _, cls_want = jax_test.box_results_with_nms_and_limit(cfg, want, boxes)
    assert len(cls_got) == len(cls_want) == cfg.MODEL.NUM_CLASSES + 1
    for j in range(1, cfg.MODEL.NUM_CLASSES + 1):
        assert cls_got[j].shape == cls_want[j].shape, f"class {j} keep set"
        np.testing.assert_allclose(cls_got[j], cls_want[j], **SCORE_TOL)


def test_run_inference_matches_jax(runs):
    cfg, _, _, (res_want, boxes_want, scores_want), (res_got, boxes_got, scores_got) = runs
    assert sorted(scores_got) == sorted(scores_want)
    for name, rec in scores_want.items():
        np.testing.assert_allclose(scores_got[name]["scores"], rec["scores"], **SCORE_TOL)
    assert len(boxes_got) == len(boxes_want) == cfg.MODEL.NUM_CLASSES + 1
    for j in range(1, cfg.MODEL.NUM_CLASSES + 1):
        for g, w in zip(boxes_got[j], boxes_want[j]):
            assert g.shape == w.shape, f"class {j} detections"
            np.testing.assert_allclose(g, w, **SCORE_TOL)
    assert set(res_got) == set(res_want) and "AP" in res_got
    for key, value in res_want.items():
        np.testing.assert_allclose(res_got[key], value, rtol=0, atol=1e-3, err_msg=key)
    assert os.path.exists(os.path.join(cfg.DATA_DIR, "torch", "detections.pkl"))


@pytest.mark.parametrize("transform_mode", ["org", "ToTensor"])
def test_single_pass_matches_jax(runs, transform_mode):
    """TTA off (one identity pass), under either input normalization:
    "org" subtracts the BGR pixel means, "ToTensor" truncates to uint8,
    scales to [0, 1] and normalizes."""
    cfg, model, variables, _, _ = runs
    cfg = clone_cfg(cfg)
    cfg.TEST.BBOX_AUG.ENABLED = False
    cfg.transform_mode = transform_mode
    rng = np.random.RandomState(7)
    im = rng.randint(0, 256, IMAGE_HW + (3,)).astype(np.uint8)
    boxes = random_rois(rng, N_PROPS, *IMAGE_HW)
    masks = (rng.rand(N_PROPS, 7, 7) > 0.4).astype(np.float32)
    want, _ = jax_test.Evaluator(cfg, build_jax_model(cfg), variables).im_detect_all(
        im, boxes, masks
    )
    evaluator = torch_test.Evaluator(cfg, model, device="cpu")
    assert evaluator.tta_pass_list(cfg) == [(IMAGE_HW[1], False)]
    got, _ = evaluator.im_detect_all(im, boxes, masks)
    assert got.shape == want.shape == (N_PROPS, 20)
    np.testing.assert_allclose(got, want, **SCORE_TOL)


def test_batched_eval_not_ported(runs):
    cfg, model, _, _, _ = runs
    cfg.TPU.EVAL_BATCH = 8
    try:
        with pytest.raises(NotImplementedError, match="EVAL_BATCH"):
            torch_engine.run_inference(cfg, model, os.path.join(cfg.DATA_DIR, "b8"), device="cpu")
    finally:
        cfg.TPU.EVAL_BATCH = 1
