"""The port's batch axis for cross-image evaluation, image by image.

Each batched op (RoIAlign's plain version and its forward kernel, the
resize of a stack, mask_valid_hw with one extent per image, the softmax
over each image's proposals, the model's forward) is held against its
single-image counterpart on the same inputs, with extents that differ
within the stack as they do when images share a bucket but not a size.
Exact where the batched op computes each image as a single call does;
the resize within rtol 1e-6, as a batched product may block its float32
sums otherwise (on this CPU it gives the same bits, which the test does
not require); the model within rtol 1e-5 (convolutions of a batch pick
their own algorithms). The kernel's cases are marked ``cuda`` and skip
without a card.
"""
import os

import numpy as np
import pytest
import torch

from cim_tpu_torch.config import load_cfg
from cim_tpu_torch.models.builder import build_model
from cim_tpu_torch.models.heads import masked_softmax_over_proposals
from cim_tpu_torch.models.layers import ceil_div_hw, mask_valid_hw
from cim_tpu_torch.ops import roi_align as ra
from cim_tpu_torch.ops.image import resize_bilinear_dynamic, resize_bilinear_dynamic_batched
from cim_tpu_torch.ops.roi_align import roi_align, roi_align_plain

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
H100_SMS = 132
H100_SMEM_OPTIN = 232448


def random_rois(rng, n, h, w, min_size=4.0):
    """(n, 4) xyxy boxes inside an (h, w) image."""
    x1 = rng.uniform(0, w - min_size, n)
    y1 = rng.uniform(0, h - min_size, n)
    x2 = np.minimum(x1 + rng.uniform(min_size, w * 0.7, n), w - 1)
    y2 = np.minimum(y1 + rng.uniform(min_size, h * 0.7, n), h - 1)
    return np.stack([x1, y1, x2, y2], -1).astype(np.float32)


def _stack_case(rng, bucket, extents, channels, scale, n):
    """Features (B, H, W, C) of a bucket whose images each fill their own
    extent (zero beyond), and n ROIs an image inside its extent, the last
    one of zero area (a padding row)."""
    feat = np.zeros((len(extents),) + bucket + (channels,), np.float32)
    rois = np.zeros((len(extents), n, 4), np.float32)
    for f, r, (vh, vw) in zip(feat, rois, extents):
        f[:vh, :vw] = rng.randn(vh, vw, channels)
        r[:] = random_rois(rng, n, vh / scale, vw / scale)
        r[-1] = 0.0
    return feat, rois


EXTENTS = [(16, 20), (13, 20), (16, 15), (9, 11)]


@pytest.mark.parametrize("sampling_ratio", [0, 2])
def test_plain_batched_is_each_image_alone(rng, sampling_ratio):
    feat, rois = _stack_case(rng, (17, 22), EXTENTS, 8, 1 / 16, 9)
    feat, rois = torch.from_numpy(feat), torch.from_numpy(rois)
    got = roi_align_plain(feat, rois, 7, 1 / 16, sampling_ratio, 4, EXTENTS)
    assert got.shape == (4, 9, 7, 7, 8)
    for b, hw in enumerate(EXTENTS):
        assert torch.equal(got[b], roi_align_plain(feat[b], rois[b], 7, 1 / 16,
                                                   sampling_ratio, 4, hw))
    # the wrapper takes the same path on the CPU, one batch in one call
    with torch.no_grad():
        assert torch.equal(roi_align(feat, rois, 7, 1 / 16, sampling_ratio, 4, EXTENTS), got)


def test_batched_roi_align_has_no_gradient(rng):
    feat, rois = _stack_case(rng, (17, 22), EXTENTS[:2], 4, 1 / 16, 5)
    feat = torch.from_numpy(feat).requires_grad_()
    with pytest.raises(ValueError, match="no backward"):
        roi_align(feat, torch.from_numpy(rois), valid_hw=EXTENTS[:2])
    with pytest.raises(ValueError, match="one \\(h, w\\) pair per image"):
        with torch.no_grad():
            roi_align(feat, torch.from_numpy(rois), valid_hw=EXTENTS[:1])


@pytest.mark.parametrize("batch", [1, 2, 8, 33])
def test_fwd_plan_of_a_batch(batch):
    """The plan of a stack takes its slice from the map of the most cells
    and deals the ROI groups so that batch x slices x groups blocks fill
    the card in one wave where the slices leave room; one image keeps the
    plan it always had."""
    bf16 = ra._ELEM_BYTES[torch.bfloat16]
    single = ra._fwd_plan(57, 75, 1024, bf16, H100_SMEM_OPTIN, H100_SMS)
    plan = ra._fwd_plan(57, 75, 1024, bf16, H100_SMEM_OPTIN, H100_SMS, batch)
    assert (plan.cs, plan.smem) == (single.cs, single.smem) == (16, 57 * 75 * 32)
    slices = 1024 // plan.cs
    assert plan.blocks == batch * slices * plan.groups
    if batch == 1:
        assert plan == single and plan.groups == 2
    assert plan.groups == max(1, H100_SMS // (batch * slices))
    assert plan.groups == 1 or plan.blocks <= H100_SMS < plan.blocks + batch * slices
    # the eval 480 pass (23x30 valid): 64-channel slices, 16 of them
    small = ra._fwd_plan(23, 30, 1024, bf16, H100_SMEM_OPTIN, H100_SMS, batch)
    assert small.cs == 64 and small.groups == max(1, H100_SMS // (16 * batch))
    n = 2047
    for p in (plan, small):  # every ROI of an image falls in one group
        dealt = np.zeros(n, int)
        for group in range(p.groups):
            dealt[group:n:p.groups] += 1
        assert (dealt == 1).all()


@pytest.mark.parametrize("hflip", [False, True])
def test_resize_batched_is_each_image_alone(rng, hflip):
    srcs = [(96, 128), (90, 124), (128, 100)]
    images = torch.from_numpy((rng.rand(3, 128, 128, 3) * 255).astype(np.float32))
    scales = [np.float32(160) / np.float32(max(hw)) for hw in srcs]
    got, extents = resize_bilinear_dynamic_batched(images, (128, 192), scales, srcs, hflip)
    assert got.shape == (3, 128, 192, 3)
    for b in range(3):
        want, ext = resize_bilinear_dynamic(images[b], (128, 192), scales[b], srcs[b], hflip)
        assert extents[b] == ext
        torch.testing.assert_close(got[b], want, rtol=1e-6, atol=0)
        assert not got[b, ext[0]:].any() and not got[b, :, ext[1]:].any()


def test_mask_valid_hw_per_image(rng):
    x = torch.from_numpy(rng.randn(4, 5, 12, 14).astype(np.float32))
    extents = [(12, 14), (7, 14), (12, 3), (1, 1)]
    got = mask_valid_hw(x, extents)
    for b, hw in enumerate(extents):
        assert torch.equal(got[b:b + 1], mask_valid_hw(x[b:b + 1], hw))
    assert mask_valid_hw(x, [(12, 14)] * 4) is x
    assert ceil_div_hw(extents, 2) == [ceil_div_hw(hw, 2) for hw in extents]
    with pytest.raises(ValueError, match="3 valid extents for a batch of 4"):
        mask_valid_hw(x, extents[:3])


def test_softmax_over_each_images_proposals(rng):
    logits = torch.from_numpy(rng.randn(3, 11, 21).astype(np.float32))
    valid = torch.from_numpy(rng.rand(3, 11) > 0.3)
    valid[:, 0] = True
    got = masked_softmax_over_proposals(logits, valid)
    for b in range(3):
        assert torch.equal(got[b], masked_softmax_over_proposals(logits[b], valid[b]))
    assert torch.allclose(got.sum(dim=1), torch.ones(3, 21))


def test_model_batched_is_each_image_alone(rng):
    cfg = load_cfg(f"{CONFIG_DIR}/resnet50_voc.yaml")
    cfg.MODEL.CONV_BODY = "tiny.conv_body"
    cfg.TPU.PRECISION = "f32"
    cfg.FAST_RCNN.MLP_HEAD_DIM = 64
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    hws = [(96, 128), (90, 124), (128, 100)]
    image = torch.zeros(3, 128, 128, 3)
    rois = np.zeros((3, 16, 4), np.float32)
    for b, (h, w) in enumerate(hws):
        image[b, :h, :w] = torch.from_numpy(rng.randn(h, w, 3).astype(np.float32))
        rois[b] = random_rois(rng, 16, h, w)
    masks = torch.from_numpy((rng.rand(3, 16, 7, 7) > 0.5).astype(np.float32))
    valid = torch.ones(3, 16, dtype=torch.bool)
    valid[1, -4:] = False
    with torch.no_grad():
        got = model(image, torch.from_numpy(rois), masks, valid, im_hw=hws)
        for b, hw in enumerate(hws):
            want = model(image[b], torch.from_numpy(rois[b]), masks[b], valid[b], im_hw=hw)
            for key, w in want.items():
                assert got[key][b].shape == w.shape, key
                torch.testing.assert_close(got[key][b], w, rtol=1e-5, atol=1e-7)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1024, 72, 5], ids=["c1024", "c72", "c5"])
@pytest.mark.parametrize("sampling_ratio", [0, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_batched_kernel_on_cuda(rng, dtype, sampling_ratio, channels):
    """The batched kernel against the plain version (float32 within 1e-5,
    bf16 within one output rounding), twice to the same bits, and each
    image bit-equal to a call of its own; one counted launch a call."""
    _cuda_or_skip()
    extents = [(57, 75), (57, 68), (52, 75), (60, 76)]
    feat, rois = _stack_case(rng, (60, 76), extents, channels, 1 / 16, 300)
    feat = torch.from_numpy(feat).cuda().to(dtype)
    rois = torch.from_numpy(rois).cuda()
    args = (feat, rois, 7, 1 / 16, sampling_ratio, 4, extents)
    before = roi_align.kernel_launches
    with torch.no_grad():
        got = roi_align(*args)
        again = roi_align(*args)
        assert roi_align.kernel_launches == before + 2
        single = [roi_align(feat[b], rois[b], 7, 1 / 16, sampling_ratio, 4, hw)
                  for b, hw in enumerate(extents)]
        want = roi_align_plain(*args)
    assert got.dtype == dtype and got.shape == want.shape
    atol = 1e-5 if dtype == torch.float32 else 1e-2 * feat.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    assert torch.equal(got, again)
    for b in range(len(extents)):
        assert torch.equal(got[b], single[b]), f"image {b}"


@pytest.mark.cuda
def test_batched_kernel_beyond_one_launch_on_cuda(rng):
    """A stack larger than a launch holds is cut into launches of
    FWD_MAX_BATCH images, each image still its own call's bits."""
    _cuda_or_skip()
    batch = ra.FWD_MAX_BATCH + 3
    extents = [(9 + b % 8, 11 + b % 9) for b in range(batch)]
    feat, rois = _stack_case(rng, (17, 22), extents, 24, 1 / 16, 7)
    feat, rois = torch.from_numpy(feat).cuda(), torch.from_numpy(rois).cuda()
    before = roi_align.kernel_launches
    with torch.no_grad():
        got = roi_align(feat, rois, 7, 1 / 16, 0, 4, extents)
        assert roi_align.kernel_launches == before + 2
        for b in (0, ra.FWD_MAX_BATCH - 1, ra.FWD_MAX_BATCH, batch - 1):
            assert torch.equal(got[b], roi_align(feat[b], rois[b], 7, 1 / 16, 0, 4, extents[b]))
