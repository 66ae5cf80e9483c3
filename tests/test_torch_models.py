"""The port's model modules against cim_tpu's, on the CPU in float32.

One flax init drives both sides (tests/torch_parity.py). Images are
96x128 buckets holding an 80x100 image, so the valid-extent masking of
the padded bucket is exercised. Bounds are those of
tests/test_full_pipeline_parity.py (rtol 2e-3, atol 2e-4): float32 conv
sums taken in another order through ~40 conv layers.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import cim_tpu.ops.pallas.roi_align_kernel as rak
from cim_tpu.config import clone_cfg
from cim_tpu.models.builder import CIMModel as JaxCIMModel
from cim_tpu.models.builder import build_model as build_jax_model
from cim_tpu.models.heads import ClsIouHead as JaxClsIouHead
from cim_tpu.models.mask_fuse import MaskFuse as JaxMaskFuse
from tests.torch_parity import MLP_DIM, init_variables, random_rois, small_cfg, torch_model

IMAGE_HW = (96, 128)
IM_HW = (80, 100)
N, N_VALID = 32, 27
TOL = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture(scope="module")
def shared():
    cfg = small_cfg()
    variables = init_variables(cfg, seed=0)
    rng = np.random.RandomState(5)
    image = np.zeros(IMAGE_HW + (3,), np.float32)
    image[: IM_HW[0], : IM_HW[1]] = rng.randn(*IM_HW, 3)
    rois = np.zeros((N, 4), np.float32)
    rois[:N_VALID] = random_rois(rng, N_VALID, *IM_HW)
    rois[0] = [0, 0, IM_HW[1] - 1, IM_HW[0] - 1]  # whole image, border taps
    masks = (rng.rand(N, 7, 7) > 0.4).astype(np.float32)
    valid = np.arange(N) < N_VALID
    return cfg, variables, torch_model(cfg, variables), (image, rois, masks, valid)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_resnet50c4_features(shared):
    cfg, variables, model, (image, *_) = shared
    want = np.asarray(build_jax_model(cfg).apply(
        variables, jnp.asarray(image), IM_HW, method=JaxCIMModel.convbody_net
    ))
    with torch.no_grad():
        got = model.convbody_net(_t(image), IM_HW).numpy()
    assert got.shape == want.shape == (6, 8, 1024)
    # the pad of the bucket is exactly zero on both sides
    assert not got[5:].any() and not got[:, 7:].any()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("pallas", [False, True], ids=["xla_cap2", "pallas_cap4"])
def test_mask_fuse(shared, monkeypatch, pallas):
    """MaskFuse at MLP width 256, against cim_tpu's XLA path (cap 2) and its
    Pallas path (cap 4, interpret mode); the port takes the cap that
    build_model chooses for the same TPU.PALLAS_ROI_ALIGN."""
    cfg, variables, _, (_, rois, masks, _) = shared
    monkeypatch.setattr(
        rak.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    cfg = clone_cfg(cfg)
    cfg.TPU.PALLAS_ROI_ALIGN = pallas
    rng = np.random.RandomState(9)
    feat = np.zeros((6, 8, 1024), np.float32)
    feat[:5, :7] = rng.randn(5, 7, 1024)
    head = JaxMaskFuse(dim_in=1024, spatial_scale=1 / 16, hidden_dim=MLP_DIM,
                       max_adaptive_grid=cfg.TPU.MAX_ADAPTIVE_GRID, use_pallas=pallas)
    want = np.asarray(head.apply(
        {"params": variables["params"]["box_head"]}, jnp.asarray(feat),
        jnp.asarray(rois), jnp.asarray(masks), (5, 7),
    ))
    model = torch_model(cfg, variables)
    with torch.no_grad():
        got = model.Box_Head(_t(feat), _t(rois), _t(masks), (5, 7)).numpy()
    assert got.shape == (N, MLP_DIM)
    np.testing.assert_allclose(got, want, **TOL)


def test_cls_iou_head(shared):
    cfg, variables, model, (_, _, _, valid) = shared
    seg_x = np.random.RandomState(2).rand(N, MLP_DIM).astype(np.float32)
    want = JaxClsIouHead(num_classes=20, refine_times=3).apply(
        {"params": variables["params"]["cls_iou"]}, jnp.asarray(seg_x), jnp.asarray(valid)
    )
    with torch.no_grad():
        got = model.cls_iou_model(_t(seg_x), _t(valid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # padding rows carry no proposal-softmax mass, valid rows all of it
    p_det = got[1].numpy()
    assert p_det[N_VALID:].max() < 1e-12
    np.testing.assert_allclose(p_det.sum(0), 1.0, rtol=1e-5)


def test_full_model(shared):
    cfg, variables, model, (image, rois, masks, valid) = shared
    want = jax.tree.map(np.asarray, jax.jit(build_jax_model(cfg).apply)(
        variables, image, rois, masks, valid, IM_HW
    ))
    with torch.no_grad():
        got = model(_t(image), _t(rois), _t(masks), _t(valid), im_hw=IM_HW)
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), want[key], err_msg=key, **TOL)
