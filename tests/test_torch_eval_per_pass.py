"""The port's per-pass TTA path and its non-fused batched path against
cim_tpu's, on the CPU in float32 with the tiny body, at
tests/test_batched_eval.py's sizes (TEST.SCALE 96, SCALES (128,), 18-22
proposals, two native sizes).

- Evaluator with TPU.FUSED_TTA off under the score / coordinate
  heuristics ID/ID, AVG/ID and UNION/UNION, with and without an aspect
  ratio pass (0.75, with its hflip), against cim_tpu's Evaluator: the
  (N, C) or, for UNION, (M * N, C) scores within rtol 2e-3, atol 2e-5
  (the port's cross-package bound, test_torch_eval_slice.py; the host
  resizes are the same cv2 calls) and the same boxes; each N-row block of
  a UNION record bit-equal to its pass's own im_detect_bbox* call.
- A pass's scores from its 128-bucket image and 256-proposal pad equal
  those of the unpadded image and proposals (rtol 2e-5, atol 1e-7,
  tests/test_eval_padding.py's bound).
- The fused path against the per-pass path, in the port: rtol 5e-3, atol
  5e-4 and correlation > 0.9999 (cim_tpu's bound for the pair,
  tests/test_batched_eval.py test_fused_tta_matches_per_pass: cv2's host
  resize against the on-device one).
- BatchedEvaluator's non-fused path at batch 2 (a partial stack, aspect
  ratio passes) against cim_tpu's BatchedEvaluator (the cross-package
  bound), against the port's Evaluator (rtol 1e-5, atol 1e-7,
  tests/test_batched_eval.py's bound) and split over two devices.
- Under UNION, BatchedEvaluator falls back to Evaluator per image.
- run_inference with cim_tpu's default heuristics (UNION/UNION) at
  EVAL_BATCH 8 against cim_tpu's: the same detections and metrics; the
  pseudo-label exporter maps a UNION record's rows to their proposals.
- The test_net CLI runs each configuration that used to raise: UNION,
  per-pass with an aspect ratio, RoIPoolF and TPU.EVAL_INT8 (records of
  the expected shape, scores in [0, 1], a finite AP).
One flax init drives both packages (tests/torch_parity.py).
"""
import os

import numpy as np
import pytest
import torch

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
from tests.torch_parity import CONFIG_DIR, init_variables, torch_model
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

CROSS_TOL = dict(rtol=2e-3, atol=2e-5)
SELF_TOL = dict(rtol=1e-5, atol=1e-7)
FUSED_TOL = dict(rtol=5e-3, atol=5e-4)


def _cfg():
    cfg = clone_cfg(load_cfg(os.path.join(CONFIG_DIR, "resnet50_voc.yaml")))
    cfg.MODEL.CONV_BODY = "tiny.conv_body"
    cfg.TPU.PRECISION = "f32"
    cfg.TPU.FUSED_TTA = False
    cfg.FAST_RCNN.MLP_HEAD_DIM = 64
    cfg.TEST.SCALE = 96
    cfg.TEST.BBOX_AUG.SCALES = (128,)
    return cfg


def _items(rng, n_images):
    """tests/test_batched_eval.py's images: two native sizes, 18 + i
    proposals."""
    items = []
    for i in range(n_images):
        h, w = (96, 128) if i % 2 == 0 else (80, 96)
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
    """One config object shared by both packages' evaluators (each reads
    it at call time, so a test sets the heuristics it needs), the port's
    model and cim_tpu's, and three images."""
    cfg = _cfg()
    variables = init_variables(cfg, seed=1)
    model = torch_model(cfg, variables)
    jax_model = build_jax_model(cfg)
    return {
        "cfg": cfg, "variables": variables, "model": model, "jax_model": jax_model,
        "items": _items(np.random.RandomState(3), 3),
        "jax_ev": jax_test.Evaluator(cfg, jax_model, variables),
        "torch_ev": torch_test.Evaluator(cfg, model, device="cpu"),
    }


@pytest.fixture
def aug(tiny):
    """Set TEST.BBOX_AUG fields of the shared config for one test."""
    a = tiny["cfg"].TEST.BBOX_AUG
    saved = dict(a)

    def set_(score, coord, ratios=()):
        a.SCORE_HEUR, a.COORD_HEUR = score, coord
        a.ASPECT_RATIOS, a.ASPECT_RATIO_H_FLIP = tuple(ratios), bool(ratios)

    yield set_
    a.update(saved)


HEURISTICS = [("ID", "ID", ()), ("AVG", "ID", ()), ("UNION", "UNION", ()),
              ("AVG", "ID", (0.75,)), ("UNION", "UNION", (0.75,))]


@pytest.mark.parametrize("score,coord,ratios", HEURISTICS,
                         ids=["ID", "AVG", "UNION", "AVG-ar", "UNION-ar"])
def test_per_pass_matches_jax(tiny, aug, score, coord, ratios):
    aug(score, coord, ratios)
    ev = tiny["torch_ev"]
    assert not (tiny["cfg"].TPU.FUSED_TTA and ev.fused_supported())
    n_passes = 4 + 2 * len(ratios)  # hflip, 128, 128 hflip, (ratio, its hflip), identity
    assert len(list(ev.iter_tta_inputs(*tiny["items"][0]))) == n_passes
    for im, boxes, masks in tiny["items"]:
        want_s, want_b = tiny["jax_ev"].im_detect_all(im, boxes, masks)
        got_s, got_b = ev.im_detect_all(im, boxes, masks)
        m = n_passes if score == "UNION" else 1
        assert got_s.shape == want_s.shape == (m * len(boxes), 20)
        np.testing.assert_allclose(got_s, want_s, **CROSS_TOL)
        np.testing.assert_array_equal(got_b, want_b)
        assert got_b.shape == (m * len(boxes), 4)


def test_union_blocks_are_the_passes(tiny, aug):
    """A UNION record stacks the passes in im_detect_all's order: hflip,
    each scale and its hflip, each aspect ratio and its hflip, identity."""
    aug("UNION", "UNION", (0.75,))
    cfg, ev = tiny["cfg"], tiny["torch_ev"]
    im, boxes, masks = tiny["items"][1]
    scores, _ = ev.im_detect_all(im, boxes, masks)
    s, ms = cfg.TEST.SCALE, cfg.TEST.MAX_SIZE
    passes = [ev.im_detect_bbox_hflip(im, boxes, masks, s, ms),
              ev.im_detect_bbox(im, boxes, masks, 128, cfg.TEST.BBOX_AUG.MAX_SIZE),
              ev.im_detect_bbox_hflip(im, boxes, masks, 128, cfg.TEST.BBOX_AUG.MAX_SIZE),
              ev.im_detect_bbox_aspect_ratio(im, boxes, masks, 0.75),
              ev.im_detect_bbox_aspect_ratio(im, boxes, masks, 0.75, hflip=True),
              ev.im_detect_bbox(im, boxes, masks, s, ms)]
    for k, (block, _) in enumerate(passes):
        np.testing.assert_array_equal(scores[k * len(boxes): (k + 1) * len(boxes)], block)


def test_unknown_heuristic_raises(tiny, aug):
    aug("MAX", "ID")
    with pytest.raises(NotImplementedError, match="MAX"):
        tiny["torch_ev"].im_detect_all(*tiny["items"][0])


def test_padded_pass_equals_unpadded(tiny):
    ev, (im, boxes, masks) = tiny["torch_ev"], tiny["items"][1]
    req = ev._prepare(im, boxes, masks, 128, 2000)
    n, h, w = req["n"], req["im_h"], req["im_w"]
    assert req["image"].shape[:2] == (128, 128) != (h, w) and req["rois"].shape[0] == 256
    padded = [torch.from_numpy(req[k]) for k in ("image", "rois", "masks", "valid")]
    bare = [torch.from_numpy(np.ascontiguousarray(req["image"][:h, :w]))] + [
        torch.from_numpy(np.ascontiguousarray(req[k][:n])) for k in ("rois", "masks", "valid")]
    got = ev._forward(*padded, h, w)[:n]
    np.testing.assert_allclose(got.numpy(), ev._forward(*bare, h, w).numpy(),
                               rtol=2e-5, atol=1e-7)


def test_fused_matches_per_pass(tiny, aug):
    aug("AVG", "ID")
    cfg_f = clone_cfg(tiny["cfg"])
    cfg_f.TPU.FUSED_TTA = True
    fused = torch_test.Evaluator(cfg_f, tiny["model"], device="cpu")
    assert fused.fused_supported()
    for it in tiny["items"]:
        want, wb = tiny["torch_ev"].im_detect_all(*it)
        got, gb = fused.im_detect_all(*it)
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_allclose(got, want, **FUSED_TOL)
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999


def test_non_fused_batched_matches_jax_and_per_pass(tiny, aug):
    aug("AVG", "ID", (0.75,))
    cfg, items = tiny["cfg"], tiny["items"]
    want = jax_test.BatchedEvaluator(cfg, tiny["jax_model"], tiny["variables"],
                                     2).im_detect_all_many(items)
    batched = torch_test.BatchedEvaluator(cfg, tiny["model"], 2, device="cpu")
    got = batched.im_detect_all_many(items)
    two = torch_test.BatchedEvaluator(cfg, tiny["model"], 2, devices=["cpu", "cpu"])
    for (gs, gb), (ws, wb), (gs2, _), it in zip(got, want, two.im_detect_all_many(items),
                                                items):
        assert gs.shape == ws.shape == (len(it[1]), 20)
        np.testing.assert_array_equal(gb, it[1])
        np.testing.assert_allclose(gs, ws, **CROSS_TOL)
        np.testing.assert_allclose(gs, tiny["torch_ev"].im_detect_all(*it)[0], **SELF_TOL)
        np.testing.assert_allclose(gs2, gs, **SELF_TOL)


def test_union_batched_falls_back_per_image(tiny, aug):
    aug("UNION", "UNION")
    batched = torch_test.BatchedEvaluator(tiny["cfg"], tiny["model"], 2, device="cpu")
    assert not batched._batched_supported()
    for (gs, gb), it in zip(batched.im_detect_all_many(tiny["items"][:2]), tiny["items"]):
        ws, wb = tiny["torch_ev"].im_detect_all(*it)
        assert gs.shape == (4 * len(it[1]), 20)
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gb, wb)


def _by_box(dets):
    """(n, 5) detections in the order of their box coordinates."""
    return dets[np.lexsort(dets[:, 3::-1].T)]


def _image_loader(entry):
    r = np.random.RandomState(entry["id"])
    return r.randint(0, 256, (entry["height"], entry["width"], 3)).astype(np.uint8)


def test_run_inference_union_matches_jax(tmp_path):
    """cim_tpu's default heuristics (UNION/UNION, TPU.FUSED_TTA on) at the
    shipped EVAL_BATCH 8: both packages take the per-pass path per image;
    the same (4 N, C) scores and (4 N, 4) boxes, detections and COCO box
    metrics. The pseudo-label exporter keeps, for each row it exports, the
    mask of the row's proposal."""
    from cim_tpu_torch.tools.generate_mask_for_MaskRCNN import export_shard

    _, props = write_synthetic_coco_dataset(str(tmp_path), 3, 20, np.random.RandomState(6),
                                            image_hw=(72, 96))
    for cat in (catalog, torch_catalog):
        cat.register_dataset("torch_per_pass_union", {
            cat.IM_DIR: str(tmp_path), cat.ANN_FN: str(tmp_path / "ann.json")})
    cfg = _cfg()
    cfg.TPU.FUSED_TTA = True
    cfg.TEST.BBOX_AUG.SCORE_HEUR = cfg.TEST.BBOX_AUG.COORD_HEUR = "UNION"
    cfg.DATA_DIR = str(tmp_path)
    cfg.TEST.DATASETS = ("torch_per_pass_union",)
    cfg.TEST.PROPOSAL_FILES = (props,)
    assert cfg.TPU.EVAL_BATCH == 8
    variables = init_variables(cfg, seed=2)
    res_w, boxes_w, scores_w = jax_engine.run_inference(
        cfg, build_jax_model(cfg), variables, str(tmp_path / "jax"), image_loader=_image_loader)
    res_g, boxes_g, scores_g = torch_engine.run_inference(
        cfg, torch_model(cfg, variables), str(tmp_path / "torch"), image_loader=_image_loader,
        device="cpu")
    assert sorted(scores_g) == sorted(scores_w)
    for name, rec in scores_w.items():
        assert scores_g[name]["scores"].shape == rec["scores"].shape == (80, 20)
        assert scores_g[name]["boxes"].shape == (80, 4)
        np.testing.assert_allclose(scores_g[name]["scores"], rec["scores"], **CROSS_TOL)
        np.testing.assert_array_equal(scores_g[name]["boxes"], rec["boxes"])
    for j in range(1, cfg.MODEL.NUM_CLASSES + 1):
        for g, w in zip(boxes_g[j], boxes_w[j]):
            # UNION repeats each box once a pass, with near-equal scores:
            # the kept set is the same, its score order may not be
            assert g.shape == w.shape, f"class {j} detections"
            np.testing.assert_allclose(_by_box(g), _by_box(w), **CROSS_TOL)
    for key, value in res_w.items():
        np.testing.assert_allclose(res_g[key], value, rtol=0, atol=1e-3, err_msg=key)

    # a UNION record whose scores sit in its last block exports what the
    # N-row record of that block exports: each kept row's own proposal
    roidb = torch_engine.get_roidb_and_dataset(cfg, cfg.TEST.DATASETS[0], props)[0]
    entries = [dict(e, gt_classes=np.ones(20, np.int32)) for e in roidb]
    union, last = {}, {}
    for e in entries:
        n = len(e["boxes"])
        block = np.random.RandomState(e["id"]).rand(n, 20).astype(np.float32)
        union[e["image"]] = {"scores": np.vstack([np.zeros((3 * n, 20), np.float32), block]),
                             "boxes": np.vstack([e["boxes"]] * 4)}
        last[e["image"]] = {"scores": block, "boxes": e["boxes"]}
    opts = {"num_classes": 20, "score_thresh": 0.5, "nms": 0.3, "is_best": False}
    _, want = export_shard((opts, entries, last, None))
    _, got = export_shard((opts, entries, union, None))
    assert len(want) > 20 and got == want


@pytest.mark.parametrize("extra,rows", [
    (["TEST.BBOX_AUG.SCORE_HEUR", "UNION", "TEST.BBOX_AUG.COORD_HEUR", "UNION"], 4),
    (["TPU.FUSED_TTA", "False", "TEST.BBOX_AUG.ASPECT_RATIOS", "(0.75,)",
      "TEST.BBOX_AUG.ASPECT_RATIO_H_FLIP", "True"], 1),
    (["FAST_RCNN.ROI_XFORM_METHOD", "RoIPoolF"], 1),
    (["TPU.EVAL_INT8", "True"], 1),
], ids=["union", "per_pass_aspect_ratio", "roipool", "int8"])
def test_test_net_runs_every_config(tmp_path, extra, rows):
    from cim_tpu_torch.ops import quant
    from cim_tpu_torch.tools import test_net

    data = str(tmp_path / "data")
    os.makedirs(data)
    _, props = write_synthetic_coco_dataset(data, 2, 30, np.random.RandomState(8),
                                            image_hw=(72, 96), write_jpegs=True)
    torch_catalog.register_dataset("torch_per_pass_cli", {
        torch_catalog.IM_DIR: data, torch_catalog.ANN_FN: os.path.join(data, "ann.json")})
    calls = quant.int_mm.calls
    det = test_net.main([
        "--cfg", os.path.join(CONFIG_DIR, "resnet50_voc.yaml"), "--device", "cpu",
        "--output_dir", str(tmp_path / "test"), "--set", "MODEL.CONV_BODY", "tiny.conv_body",
        "FAST_RCNN.MLP_HEAD_DIM", "64", "TPU.PRECISION", "f32", "TEST.SCALE", "96",
        "TEST.BBOX_AUG.SCALES", "(128,)", "TEST.DATASETS", "('torch_per_pass_cli',)",
        "TEST.PROPOSAL_FILES", f"('{props}',)", "DATA_DIR", data, *extra])
    assert len(det["all_scores"]) == 2
    for rec in det["all_scores"].values():
        s = rec["scores"]
        assert s.shape == (rows * 30, 20) and rec["boxes"].shape == (rows * 30, 4)
        assert np.isfinite(s).all() and 0 <= s.min() <= s.max() <= 1
    assert np.isfinite(det["results"]["AP"])
    assert (quant.int_mm.calls > calls) == ("TPU.EVAL_INT8" in extra)
    assert det["model"].Box_Head.roi_method == ("RoIPoolF" if "RoIPoolF" in extra else "RoIAlign")
