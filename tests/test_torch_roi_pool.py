"""The port's RoIPool (ROI_XFORM_METHOD RoIPoolF) against cim_tpu's, on
the CPU.

- roi_pool forward against cim_tpu.ops.roi_align.roi_pool on the same
  seeded features and ROIs, one image and a stack with per-image valid
  extents: equal bit for bit (a max moves no bits; the bins' integer
  corners are the same float32 operations), float32 and bf16, ROIs that
  overflow the valid extent (clipped and empty bins give 0) and bins wider
  than max_bin_cells.
- The gradient of a weighted sum of its output with respect to the
  features against jax.grad of cim_tpu's: rtol 1e-6, atol 1e-6 (each
  cell's gradient is a float32 sum of the weights of the bins whose max it
  is, in another order; ties split in halves on both sides).
- A CIMModel built with RoIPoolF: cim_tpu's Evaluator scores against the
  port's, one pass and the hflip pass, tiny body, float32: rtol 2e-3,
  atol 2e-5 (the port's cross-package bound, test_torch_eval_slice.py).
- A Trainer step of a RoIPoolF model trains the body: finite losses and a
  non-zero gradient into every Conv_Body tensor.
One flax init drives both packages (tests/torch_parity.py).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cim_tpu.models.tiny  # noqa: F401  (registers tiny.conv_body)
from cim_tpu.config import clone_cfg, load_cfg
from cim_tpu.engine import test as jax_test
from cim_tpu.models.builder import build_model as build_jax_model
from cim_tpu.ops.roi_align import roi_pool as jax_roi_pool
from cim_tpu_torch.engine import test as torch_test
from cim_tpu_torch.models.builder import build_model
from cim_tpu_torch.ops.roi_align import roi_pool
from tests.torch_parity import CONFIG_DIR, init_variables, random_rois, torch_model
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

CROSS_TOL = dict(rtol=2e-3, atol=2e-5)
GRAD_TOL = dict(rtol=1e-6, atol=1e-6)


def _rois(rng, n, h, w, scale):
    """ROIs over an (h / scale, w / scale) image, a few reaching beyond it
    and a few wide enough for bins of more than max_bin_cells cells."""
    rois = random_rois(rng, n, h / scale, w / scale, min_size=2.0)
    rois[: n // 8, 2:] += rng.uniform(20, 60, (n // 8, 2)).astype(np.float32)
    rois[-2] = [0, 0, 20 * 8 / scale, 20 * 8 / scale]  # 20 cells a side
    return rois


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("valid_hw", [None, (11, 13)])
def test_roi_pool_matches_jax(dtype, valid_hw):
    rng = np.random.RandomState(0)
    feats = rng.randn(14, 17, 24).astype(np.float32)
    rois = _rois(rng, 40, 14, 17, 1 / 4)
    jf = jnp.asarray(feats, dtype)
    want = np.asarray(jax_roi_pool(jf, jnp.asarray(rois), 7, 1 / 4, valid_hw=valid_hw)
                      .astype(jnp.float32))
    tf = torch.from_numpy(feats).to(getattr(torch, dtype))
    got = roi_pool(tf, torch.from_numpy(rois), 7, 1 / 4, valid_hw=valid_hw)
    assert got.dtype == tf.dtype and got.shape == (40, 7, 7, 24)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert (want == 0).all(axis=(1, 2, 3)).sum() < 40  # not all empty


def test_roi_pool_stack_is_each_image_alone():
    rng = np.random.RandomState(1)
    feats = rng.randn(3, 12, 16, 8).astype(np.float32)
    rois = np.stack([_rois(rng, 24, 12, 16, 1 / 8) for _ in range(3)])
    extents = [(12, 16), (9, 14), (7, 16)]
    got = roi_pool(torch.from_numpy(feats), torch.from_numpy(rois), 7, 1 / 8, valid_hw=extents)
    for b in range(3):
        want = np.asarray(jax_roi_pool(jnp.asarray(feats[b]), jnp.asarray(rois[b]), 7, 1 / 8,
                                       valid_hw=extents[b]))
        np.testing.assert_array_equal(got[b].numpy(), want)


@pytest.mark.parametrize("ties", [False, True])
def test_roi_pool_gradient_matches_jax_grad(ties):
    """jax.grad of sum(w * roi_pool(F)) against autograd's. With ``ties``
    the features are rounded to a few values, so many bins hold their max
    in more than one cell."""
    rng = np.random.RandomState(2)
    feats = rng.randn(10, 12, 6).astype(np.float32)
    if ties:
        feats = np.round(feats)
    rois = _rois(rng, 16, 10, 12, 1 / 4)
    w = rng.randn(16, 7, 7, 6).astype(np.float32)
    valid = (9, 11)
    want = np.asarray(jax.grad(lambda f: jnp.sum(
        jax_roi_pool(f, jnp.asarray(rois), 7, 1 / 4, valid_hw=valid) * w))(jnp.asarray(feats)))
    tf = torch.from_numpy(feats).requires_grad_(True)
    (roi_pool(tf, torch.from_numpy(rois), 7, 1 / 4, valid_hw=valid) * torch.from_numpy(w)).sum() \
        .backward()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(tf.grad.numpy(), want, **GRAD_TOL)


def _cfg():
    cfg = clone_cfg(load_cfg(os.path.join(CONFIG_DIR, "resnet50_voc.yaml")))
    cfg.MODEL.CONV_BODY = "tiny.conv_body"
    cfg.TPU.PRECISION = "f32"
    cfg.FAST_RCNN.MLP_HEAD_DIM = 64
    cfg.FAST_RCNN.ROI_XFORM_METHOD = "RoIPoolF"
    cfg.TEST.SCALE = 96
    cfg.TEST.BBOX_AUG.SCALES = ()
    return cfg


def test_roi_pool_model_scores_match_jax():
    cfg = _cfg()
    variables = init_variables(cfg, seed=4)
    model = torch_model(cfg, variables)
    assert model.Box_Head.roi_method == "RoIPoolF"
    rng = np.random.RandomState(4)
    im = (rng.rand(96, 128, 3) * 255).astype(np.uint8)
    boxes = random_rois(rng, 20, 96, 128, min_size=8.0)
    masks = (rng.rand(20, 7, 7) > 0.5).astype(np.float32)
    want, _ = jax_test.Evaluator(cfg, build_jax_model(cfg), variables).im_detect_all(
        im, boxes, masks)
    got, _ = torch_test.Evaluator(cfg, model, device="cpu").im_detect_all(im, boxes, masks)
    assert got.shape == (20, 20) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **CROSS_TOL)


def test_unknown_roi_method_raises():
    cfg = _cfg()
    cfg.FAST_RCNN.ROI_XFORM_METHOD = "RoICrop"
    with pytest.raises(ValueError, match="Unknown pooling method"):
        build_model(cfg, device="cpu")


def test_roi_pool_trainer_step_trains_the_body():
    from cim_tpu_torch.data.synthetic import make_microbatch
    from cim_tpu_torch.engine.train import Trainer

    cfg = _cfg()
    cfg.TPU.GRAD_ACCUM = 1
    cfg.TPU.DATA_PARALLEL = 1
    trainer = Trainer(cfg, device="cpu", seed=0)
    batch = {k: v[None] for k, v in make_microbatch(
        np.random.RandomState(0), image_hw=(64, 80), n_props=24, n_valid=20,
        num_classes=20).items()}
    metrics = trainer.step(batch)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    body = [(n, p) for n, p in trainer.model.named_parameters() if n.startswith("Conv_Body.")]
    assert body and all(p.grad is not None and p.grad.abs().max() > 0 for _, p in body), \
        [n for n, p in body if p.grad is None or not p.grad.abs().max() > 0]
