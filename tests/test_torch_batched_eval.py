"""The port's cross-image batched evaluation, on the CPU in float32.

- BatchedEvaluator against cim_tpu's, fused TTA, tiny body, stacks of 2
  and 4, over images that include a stack of mixed sizes in one bucket
  (96x128 and 90x124 share the 128x128 bucket and the 0.75 ratio bucket)
  and partial stacks (cim_tpu pads those by repeating the last image; the
  port runs them at their size). Bound: rtol 2e-3, atol 2e-5, the port's
  cross-package bound (test_torch_eval_slice.py).
- BatchedEvaluator against the port's own Evaluator, image by image.
  Bound: rtol 1e-5, atol 1e-7, tests/test_batched_eval.py's bound.
- run_inference of the resnet50_voc config at its EVAL_BATCH (8, the
  default) against cim_tpu's: the same detections within the
  cross-package bound and the same evaluation results.
One flax init drives both packages (tests/torch_parity.py).
"""
import os

import numpy as np
import pytest

import cim_tpu.models.tiny  # noqa: F401  (registers tiny.conv_body)
from cim_tpu.config import clone_cfg, load_cfg
from cim_tpu.data import catalog
from cim_tpu.data.synthetic import write_synthetic_coco_dataset
from cim_tpu.engine import test as jax_test
from cim_tpu.engine import test_engine as jax_engine
from cim_tpu.models.builder import build_model as build_jax_model
from cim_tpu_torch.data import catalog as torch_catalog
from cim_tpu_torch.engine import test as torch_test
from cim_tpu_torch.engine import test_engine as torch_engine
from tests.torch_parity import CONFIG_DIR, init_variables, small_cfg, torch_model

CROSS_TOL = dict(rtol=2e-3, atol=2e-5)
SELF_TOL = dict(rtol=1e-5, atol=1e-7)
# native sizes: a 0.75-ratio stack of two sizes in the 128x128 bucket,
# an 80x96 image (same bucket, ratio bucket 0.875) and a portrait one
SIZES = [(96, 128), (90, 124), (96, 128), (80, 96), (90, 124), (150, 100), (96, 128)]


def _tiny_cfg():
    cfg = clone_cfg(load_cfg(os.path.join(CONFIG_DIR, "resnet50_voc.yaml")))
    cfg.MODEL.CONV_BODY = "tiny.conv_body"
    cfg.TPU.PRECISION = "f32"
    cfg.TPU.FUSED_TTA = True
    cfg.FAST_RCNN.MLP_HEAD_DIM = 64
    cfg.TEST.SCALE = 96
    cfg.TEST.BBOX_AUG.SCALES = (128,)
    return cfg


def _items(rng):
    items = []
    for i, (h, w) in enumerate(SIZES):
        im = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        n = 18 + i
        x1 = rng.uniform(0, w * 0.4, n)
        y1 = rng.uniform(0, h * 0.4, n)
        boxes = np.stack([x1, y1, x1 + rng.uniform(8, w * 0.5, n),
                          y1 + rng.uniform(8, h * 0.5, n)], -1).astype(np.float32)
        items.append((im, boxes, (rng.rand(n, 7, 7) > 0.5).astype(np.float32)))
    return items


@pytest.fixture(scope="module")
def tiny():
    cfg = _tiny_cfg()
    variables = init_variables(cfg, seed=2)
    items = _items(np.random.RandomState(5))
    model = torch_model(cfg, variables)
    sequential = torch_test.Evaluator(cfg, model, device="cpu")
    return cfg, variables, items, model, [sequential.im_detect_all(*it) for it in items]


def test_stacks_hold_mixed_sizes_and_partials(tiny):
    """The fixture's images group as the test means them to: one key holds
    five images of two sizes, so stacks of 2 and 4 both leave a partial."""
    cfg, _, items, model, _ = tiny
    ev = torch_test.BatchedEvaluator(cfg, model, 2, device="cpu")
    keys = {}
    for idx, it in enumerate(items):
        req = ev._prepare_raw(*it)
        keys.setdefault((req["image"].shape, req["rois"].shape[0], req["ratio_hw"]), []).append(idx)
    assert sorted(map(len, keys.values())) == [1, 1, 5]
    assert {SIZES[i] for i in max(keys.values(), key=len)} == {(96, 128), (90, 124)}


@pytest.mark.parametrize("batch_size", [2, 4])
def test_batched_matches_jax(tiny, batch_size):
    cfg, variables, items, model, _ = tiny
    want = jax_test.BatchedEvaluator(cfg, build_jax_model(cfg), variables,
                                     batch_size).im_detect_all_many(items)
    got = torch_test.BatchedEvaluator(cfg, model, batch_size,
                                      device="cpu").im_detect_all_many(items)
    assert len(got) == len(want) == len(items)
    for (gs, gb), (ws, wb), (_, boxes, _) in zip(got, want, items):
        assert gs.shape == ws.shape == (len(boxes), 20)
        np.testing.assert_array_equal(gb, boxes)
        np.testing.assert_allclose(gs, ws, **CROSS_TOL)


@pytest.mark.parametrize("batch_size", [2, 4])
def test_batched_matches_sequential(tiny, batch_size):
    cfg, _, items, model, want = tiny
    got = torch_test.BatchedEvaluator(cfg, model, batch_size,
                                      device="cpu").im_detect_all_many(items)
    for (gs, gb), (ws, wb) in zip(got, want):
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_allclose(gs, ws, **SELF_TOL)


def test_batched_single_pass_org_mode(tiny):
    """TTA off and the "org" input normalization (BGR minus the pixel
    means) take the batched path too."""
    cfg, _, items, model, _ = tiny
    cfg = clone_cfg(cfg)
    cfg.TEST.BBOX_AUG.ENABLED = False
    cfg.transform_mode = "org"
    got = torch_test.BatchedEvaluator(cfg, model, 4, device="cpu").im_detect_all_many(items)
    sequential = torch_test.Evaluator(cfg, model, device="cpu")
    for (gs, _), it in zip(got, items):
        np.testing.assert_allclose(gs, sequential.im_detect_all(*it)[0], **SELF_TOL)


def _image_loader(entry):
    r = np.random.RandomState(entry["id"])
    return r.randint(0, 256, (entry["height"], entry["width"], 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def eval_batch_8(tmp_path_factory):
    """run_inference of both packages over 5 images of the shipped config
    with its EVAL_BATCH (a partial stack of 5 under 8) and the narrow head
    of tests/torch_parity.small_cfg."""
    tmp = tmp_path_factory.mktemp("torch_batched_eval")
    _, props = write_synthetic_coco_dataset(
        str(tmp), 5, 30, np.random.RandomState(6), image_hw=(72, 96)
    )
    for cat in (catalog, torch_catalog):
        cat.register_dataset("torch_batched_eval", {
            cat.IM_DIR: str(tmp), cat.ANN_FN: str(tmp / "ann.json"),
        })
    cfg = small_cfg(from_yaml=True)
    assert cfg.TPU.EVAL_BATCH == 8 and cfg.TPU.FUSED_TTA
    cfg.DATA_DIR = str(tmp)
    cfg.TEST.DATASETS = ("torch_batched_eval",)
    cfg.TEST.PROPOSAL_FILES = (props,)
    cfg.TEST.SCALE = 96
    cfg.TEST.BBOX_AUG.SCALES = (128,)
    variables = init_variables(cfg, seed=3)
    want = jax_engine.run_inference(cfg, build_jax_model(cfg), variables, str(tmp / "jax"),
                                    image_loader=_image_loader)
    model = torch_model(cfg, variables)
    got = torch_engine.run_inference(cfg, model, str(tmp / "torch"),
                                     image_loader=_image_loader, device="cpu")
    return cfg, model, want, got


def test_run_inference_eval_batch_8_matches_jax(eval_batch_8):
    cfg, _, (res_want, boxes_want, scores_want), (res_got, boxes_got, scores_got) = eval_batch_8
    assert sorted(scores_got) == sorted(scores_want) and len(scores_got) == 5
    for name, rec in scores_want.items():
        assert scores_got[name]["scores"].shape == (30, 20)
        np.testing.assert_allclose(scores_got[name]["scores"], rec["scores"], **CROSS_TOL)
    assert len(boxes_got) == len(boxes_want) == cfg.MODEL.NUM_CLASSES + 1
    for j in range(1, cfg.MODEL.NUM_CLASSES + 1):
        for g, w in zip(boxes_got[j], boxes_want[j]):
            assert g.shape == w.shape, f"class {j} detections"
            np.testing.assert_allclose(g, w, **CROSS_TOL)
    assert set(res_got) == set(res_want) and "AP" in res_got
    for key, value in res_want.items():
        np.testing.assert_allclose(res_got[key], value, rtol=0, atol=1e-3, err_msg=key)
    assert os.path.exists(os.path.join(cfg.DATA_DIR, "torch", "detections.pkl"))


def test_eval_devices_on_one_device_warns(eval_batch_8, caplog):
    """TPU.EVAL_DEVICES above 1 with one device: a warning, then the one
    device (cim_tpu clamps to its local devices the same way)."""
    cfg, model, _, (_, _, scores_got) = eval_batch_8
    cfg = clone_cfg(cfg)
    cfg.TPU.EVAL_DEVICES = 2
    with caplog.at_level("WARNING"):
        _, _, scores = torch_engine.run_inference(
            cfg, model, os.path.join(cfg.DATA_DIR, "dev2"), image_loader=_image_loader,
            ind_range=(0, 1), device="cpu")
    assert "EVAL_DEVICES=2" in caplog.text
    for name, rec in scores.items():
        np.testing.assert_allclose(rec["scores"], scores_got[name]["scores"], **SELF_TOL)
