"""The port's RoIAlign against cim_tpu's, on the CPU.

The plain PyTorch versions (the CPU path of cim_tpu_torch.ops.roi_align
and the oracles of its CUDA kernels), forward and backward, are held
against:
- the XLA op cim_tpu.ops.roi_align.roi_align, at grid caps 2 (cim_tpu's XLA
  path, TPU.MAX_ADAPTIVE_GRID) and 4 (its Pallas path), and its jax.grad;
- the Pallas kernel roi_align_pallas in interpret mode, at cap 4, and the
  jax.grad through its custom_vjp (the TPU _bwd_kernel).
Backward comparisons take the gradient of sum(roi_align(F) * G) with
respect to F for a seeded G, in float32 (rtol 1e-4, atol 1e-5: sums in
another order). The CUDA kernels have no CPU or interpret mode: the tests
marked ``cuda`` hold them against the plain versions on the card and skip
without one (chip_smoke.py does the same at the main paths' full shapes).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import cim_tpu.ops.pallas.roi_align_kernel as rak
from cim_tpu.ops.roi_align import roi_align as jax_roi_align
from cim_tpu_torch.ops import roi_align as ra
from cim_tpu_torch.ops.roi_align import (
    roi_align,
    roi_align_backward,
    roi_align_backward_plain,
    roi_align_plain,
)

N = 7


@pytest.fixture
def interpret_mode(monkeypatch):
    # run the Pallas kernel in interpreter mode on the CPU test backend
    monkeypatch.setattr(
        rak.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _case(rng, scale, h=16, w=20, c=8, pad=(3, 5)):
    """A zero-padded feature bucket with valid extent (h, w) and N rois
    across the image, one out to its border and one of zero area (a
    padding row)."""
    feat = np.zeros((h + pad[0], w + pad[1], c), np.float32)
    feat[:h, :w] = rng.randn(h, w, c)
    img_h, img_w = h / scale, w / scale
    x1 = rng.uniform(-8, img_w * 0.6, N)
    y1 = rng.uniform(-8, img_h * 0.6, N)
    rois = np.stack(
        [x1, y1, x1 + rng.uniform(2, img_w * 0.6, N), y1 + rng.uniform(2, img_h * 0.6, N)], -1
    ).astype(np.float32)
    rois[-2] = [img_w * 0.5, img_h * 0.5, img_w - 1, img_h - 1]
    rois[-1] = 0.0
    return feat, rois, (h, w)


@pytest.mark.parametrize("scale", [1 / 16, 1 / 8, 1 / 32])
@pytest.mark.parametrize("sampling_ratio", [0, 2])
@pytest.mark.parametrize("cap", [2, 4])
def test_plain_matches_xla(rng, scale, sampling_ratio, cap):
    feat, rois, valid = _case(rng, scale)
    want = np.asarray(jax_roi_align(
        jnp.asarray(feat), jnp.asarray(rois), output_size=7, spatial_scale=scale,
        sampling_ratio=sampling_ratio, aligned=True, max_adaptive_grid=cap,
        valid_hw=valid,
    ))
    got = roi_align(torch.from_numpy(feat), torch.from_numpy(rois), 7, scale,
                    sampling_ratio, cap, valid).numpy()
    assert got.shape == (N, 7, 7, feat.shape[2])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sampling_ratio", [0, 2])
@pytest.mark.parametrize("padded", [False, True])
def test_plain_matches_pallas(rng, interpret_mode, sampling_ratio, padded):
    feat, rois, valid = _case(rng, 1 / 16)
    if not padded:
        feat = np.ascontiguousarray(feat[: valid[0], : valid[1]])
        valid = None
    want = np.asarray(rak.roi_align_pallas(
        jnp.asarray(feat), jnp.asarray(rois), 7, 1 / 16, sampling_ratio, 4,
        4, 4, valid_hw=valid,
    ))
    got = roi_align(torch.from_numpy(feat), torch.from_numpy(rois), 7, 1 / 16,
                    sampling_ratio, 4, valid).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_cpu_wrapper_launches_no_kernel(rng):
    feat, rois, valid = _case(rng, 1 / 16)
    before = roi_align.kernel_launches
    roi_align(torch.from_numpy(feat), torch.from_numpy(rois), valid_hw=valid)
    assert roi_align.kernel_launches == before
    if not torch.cuda.is_available():
        assert before == 0


def test_wrapper_refuses_other_devices():
    feat = torch.empty((4, 4, 8), device="meta")
    rois = torch.empty((2, 4), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        roi_align(feat, rois)


def test_plain_bf16_sums_in_f32(rng):
    """bf16 features give a bf16 result: the f32 sum over the same bf16
    values, rounded once (the bound the CUDA kernel is held to)."""
    feat, rois, valid = _case(rng, 1 / 16, c=16)
    fb = torch.from_numpy(feat).to(torch.bfloat16)
    got = roi_align_plain(fb, torch.from_numpy(rois), 7, 1 / 16, 0, 4, valid)
    want = roi_align_plain(fb.float(), torch.from_numpy(rois), 7, 1 / 16, 0, 4, valid)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)


def test_plain_no_rois(rng):
    feat, _, valid = _case(rng, 1 / 16)
    out = roi_align(torch.from_numpy(feat), torch.zeros((0, 4)), valid_hw=valid)
    assert out.shape == (0, 7, 7, feat.shape[2])


def _grad_case(rng, scale, padded, **kw):
    feat, rois, valid = _case(rng, scale, **kw)
    if not padded:
        feat = np.ascontiguousarray(feat[: valid[0], : valid[1]])
        valid = None
    g = rng.randn(N, 7, 7, feat.shape[2]).astype(np.float32)
    return feat, rois, valid, g


def _jax_grad(fn, feat, g):
    return np.asarray(jax.grad(lambda f: jnp.sum(fn(f) * g))(jnp.asarray(feat)))


def _torch_grads(feat, rois, g, sampling_ratio, cap, valid, scale=1 / 16):
    """(roi_align_backward_plain, autograd through roi_align) on the CPU."""
    plain = roi_align_backward_plain(
        torch.from_numpy(g), torch.from_numpy(rois), feat.shape[0], feat.shape[1],
        7, scale, sampling_ratio, cap, valid).numpy()
    f = torch.from_numpy(feat).requires_grad_()
    out = roi_align(f, torch.from_numpy(rois), 7, scale, sampling_ratio, cap, valid)
    (out * torch.from_numpy(g)).sum().backward()
    return plain, f.grad.numpy()


@pytest.mark.parametrize("sampling_ratio", [0, 2])
@pytest.mark.parametrize("padded", [False, True])
def test_backward_plain_matches_pallas_grad(rng, interpret_mode, sampling_ratio, padded):
    """Against jax.grad through roi_align_pallas (its _bwd_kernel), cap 4,
    N = 7 ROIs (not a multiple of the kernel's 16-ROI block)."""
    feat, rois, valid, g = _grad_case(rng, 1 / 16, padded)
    want = _jax_grad(lambda f: rak.roi_align_pallas(
        f, jnp.asarray(rois), 7, 1 / 16, sampling_ratio, 4, 4, 4, valid_hw=valid), feat, g)
    plain, auto = _torch_grads(feat, rois, g, sampling_ratio, 4, valid)
    assert plain.shape == feat.shape
    np.testing.assert_allclose(plain, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(auto, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("scale", [1 / 16, 1 / 8])
@pytest.mark.parametrize("sampling_ratio", [0, 2])
def test_backward_plain_matches_xla_grad(rng, scale, sampling_ratio):
    """Against jax.grad of the XLA roi_align at cim_tpu's XLA cap 2, on a
    padded bucket."""
    feat, rois, valid, g = _grad_case(rng, scale, padded=True)
    want = _jax_grad(lambda f: jax_roi_align(
        f, jnp.asarray(rois), output_size=7, spatial_scale=scale,
        sampling_ratio=sampling_ratio, aligned=True, max_adaptive_grid=2,
        valid_hw=valid), feat, g)
    plain, auto = _torch_grads(feat, rois, g, sampling_ratio, 2, valid, scale)
    np.testing.assert_allclose(plain, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(auto, want, rtol=1e-4, atol=1e-5)


def test_backward_plain_is_autograd_of_plain_forward(rng):
    """The scatter form equals torch's own autograd through the gather
    form of roi_align_plain, and the padded bucket's pad gets zero."""
    feat, rois, valid, g = _grad_case(rng, 1 / 16, padded=True)
    f = torch.from_numpy(feat).requires_grad_()
    (roi_align_plain(f, torch.from_numpy(rois), 7, 1 / 16, 0, 4, valid)
     * torch.from_numpy(g)).sum().backward()
    plain, _ = _torch_grads(feat, rois, g, 0, 4, valid)
    np.testing.assert_allclose(plain, f.grad.numpy(), rtol=1e-5, atol=1e-6)
    assert not plain[valid[0]:].any() and not plain[:, valid[1]:].any()


def test_backward_plain_bf16_sums_in_f32(rng):
    """bf16 grads give a bf16 result: the f32 sum rounded once."""
    feat, rois, valid, g = _grad_case(rng, 1 / 16, padded=True, c=16)
    gb = torch.from_numpy(g).to(torch.bfloat16)
    args = (torch.from_numpy(rois), feat.shape[0], feat.shape[1], 7, 1 / 16, 0, 4, valid)
    got = roi_align_backward_plain(gb, *args)
    want = roi_align_backward_plain(gb.float(), *args)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)


def test_cpu_backward_launches_no_kernel(rng):
    feat, rois, valid, g = _grad_case(rng, 1 / 16, padded=True)
    before = roi_align_backward.kernel_launches
    _torch_grads(feat, rois, g, 0, 4, valid)
    assert roi_align_backward.kernel_launches == before


H100_SMEM_OPTIN, H100_SMS = 232448, 132  # opt-in shared memory a block, SMs


@pytest.mark.parametrize("hwc", [(24, 32, 1024), (60, 76, 1024), (76, 100, 1024),
                                 (75, 125, 1024), (120, 152, 512), (60, 76, 72),
                                 (60, 76, 5)], ids=lambda v: "x".join(map(str, v)))
def test_bwd_plan_covers_the_map_once(hwc):
    """The backward kernel's plan at the train shapes (scales 480 and 1200,
    the padded buckets, stride 8) and at ragged channel counts: it fits the
    card's shared memory, fills the card, and its row bands, column tiles,
    channel slices and runs of ROIs cover every row, column, channel and
    ROI exactly once."""
    height, width, channels = hwc
    plan = ra._bwd_plan(height, width, channels, H100_SMEM_OPTIN, H100_SMS)
    assert plan.smem <= H100_SMEM_OPTIN
    for extent, step in ((height, plan.band_rows), (width, plan.tile_cols), (channels, plan.cs)):
        cover = np.zeros(extent, int)
        for start in range(0, extent, step):
            cover[start:start + step] += 1
        assert (cover == 1).all()
    tiles = -(-height // plan.band_rows) * -(-width // plan.tile_cols) * -(-channels // plan.cs)
    assert plan.blocks == plan.splits * tiles >= ra.BWD_BLOCKS_PER_SM * H100_SMS
    assert plan.splits == 1 or (plan.splits - 1) * tiles < ra.BWD_BLOCKS_PER_SM * H100_SMS
    n = 2047
    runs = [(k * n // plan.splits, (k + 1) * n // plan.splits) for k in range(plan.splits)]
    assert runs[0][0] == 0 and runs[-1][1] == n
    assert all(a[1] == b[0] and a[0] <= a[1] for a, b in zip(runs, runs[1:]))


def test_bwd_plan_refuses_what_the_kernel_cannot_hold():
    with pytest.raises(ValueError, match="bins per axis"):
        ra._bwd_plan(60, 76, 1024, H100_SMEM_OPTIN, H100_SMS, output_size=8)
    with pytest.raises(ValueError, match="shared memory"):
        ra._bwd_plan(60, 76, 1024, 48 * 1024, H100_SMS)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("vhw_c", [(23, 30, 1024), (57, 75, 1024), (75, 75, 1024),
                                   (75, 100, 1024), (113, 150, 512), (29, 38, 2048),
                                   (57, 75, 72), (23, 30, 5)],
                         ids=lambda v: "x".join(map(str, v)))
def test_fwd_plan_covers_the_map_once(vhw_c, dtype):
    """The forward kernel's plan at the eval passes' valid extents (480,
    1200, the square 1200 map, the padded 76x100 bucket), at strides 8 and
    32, and at ragged channel counts: its slice of the valid map fits the
    card's shared memory, its slices cover every channel exactly once, its
    groups cover every ROI exactly once, and its blocks fill the card in
    one wave where the slices leave room."""
    vh, vw, channels = vhw_c
    elem = ra._ELEM_BYTES[dtype]
    plan = ra._fwd_plan(vh, vw, channels, elem, H100_SMEM_OPTIN, H100_SMS)
    assert plan.smem == vh * vw * plan.cs * elem <= H100_SMEM_OPTIN
    assert plan.cs & (plan.cs - 1) == 0
    assert ra.FWD_MIN_CELL_BYTES <= plan.cs * elem <= ra.FWD_MAX_CELL_BYTES
    slices = -(-channels // plan.cs)
    cover = np.zeros(slices * plan.cs, int)
    for start in range(0, channels, plan.cs):
        cover[start:start + plan.cs] += 1
    assert (cover[:channels] == 1).all() and slices * plan.cs - channels < plan.cs
    n = 2047
    rois = np.zeros(n, int)
    for group in range(plan.groups):  # the kernel's ROIs of a group
        rois[group:n:plan.groups] += 1
    assert (rois == 1).all()
    assert plan.blocks == slices * plan.groups
    assert plan.groups == 1 or plan.blocks <= H100_SMS < plan.blocks + slices


def test_fwd_plan_widest_slice_and_refusal():
    """The eval map of the 1200 pass takes 16 bf16 channels (32 bytes) a
    cell and the stride-8 map 4 (8 bytes); a map whose narrowest slice (8
    bytes a cell) does not fit is refused."""
    bf16 = ra._ELEM_BYTES[torch.bfloat16]
    assert ra._fwd_plan(57, 75, 1024, bf16, H100_SMEM_OPTIN, H100_SMS).cs == 16
    assert ra._fwd_plan(75, 75, 1024, bf16, H100_SMEM_OPTIN, H100_SMS).cs == 16
    assert ra._fwd_plan(113, 150, 512, bf16, H100_SMEM_OPTIN, H100_SMS).cs == 4
    assert ra._fwd_plan(23, 30, 1024, bf16, H100_SMEM_OPTIN, H100_SMS).cs == 64
    with pytest.raises(ValueError, match="shared memory"):
        ra._fwd_plan(400, 400, 8, 4, H100_SMEM_OPTIN, H100_SMS)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")


def _map_case(rng, shape, valid, scale, n=64):
    """A zero-padded bucket of the given shape and valid extent with n ROIs
    up to the whole valid map: the first over all of it, the last of zero
    area (a padding row)."""
    feat = np.zeros(shape, np.float32)
    feat[: valid[0], : valid[1]] = rng.randn(valid[0], valid[1], shape[2])
    img_h, img_w = valid[0] / scale, valid[1] / scale
    x1, y1 = rng.uniform(0, img_w * 0.9, n), rng.uniform(0, img_h * 0.9, n)
    rois = np.stack([x1, y1, np.minimum(x1 + rng.uniform(8, img_w, n), img_w - 1),
                     np.minimum(y1 + rng.uniform(8, img_h, n), img_h - 1)], -1)
    rois[0] = [0.0, 0.0, img_w - 1.0, img_h - 1.0]
    rois[-1] = 0.0
    return feat, rois.astype(np.float32), valid


# (features, valid extent, scale) of the forward kernel's cases
_FWD_CASES = {
    "vec16B": lambda rng: (*_case(rng, 1 / 16, c=72), 1 / 16),
    "scalar": lambda rng: (*_case(rng, 1 / 16, c=5), 1 / 16),
    # the square image's 1200 pass: a 75x75 valid map in a 76x76 bucket
    "square75x75": lambda rng: (*_map_case(rng, (76, 76, 1024), (75, 75), 1 / 16), 1 / 16),
    # stride 8: the narrow slice (8 bytes a cell in bf16)
    "stride8": lambda rng: (*_map_case(rng, (120, 152, 512), (113, 150), 1 / 8), 1 / 8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_FWD_CASES))
@pytest.mark.parametrize("sampling_ratio", [0, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_matches_plain_on_cuda(rng, dtype, sampling_ratio, case):
    """The kernel against the plain version on the same CUDA inputs: float32
    within 1e-5 (sums in another order), bf16 within one output rounding;
    two calls give the same bits. 72 channels take the 16-byte copies and
    stores, 5 the element-wise ones; the square 1200 map and the stride-8
    map take the widest valid map of the eval path and the narrowest slice."""
    _cuda_or_skip()
    feat, rois, valid, scale = _FWD_CASES[case](rng)
    feat = torch.from_numpy(feat).cuda().to(dtype)
    rois = torch.from_numpy(rois).cuda()
    args = (feat, rois, 7, scale, sampling_ratio, 4, valid)
    before = roi_align.kernel_launches
    with torch.no_grad():
        got = roi_align(*args)
        again = roi_align(*args)
        want = roi_align_plain(*args)
    assert roi_align.kernel_launches == before + 2
    assert got.dtype == dtype and got.shape == want.shape
    atol = 1e-5 if dtype == torch.float32 else 1e-2 * feat.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [72, 5], ids=["c72", "c5"])
@pytest.mark.parametrize("sampling_ratio", [0, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_kernel_matches_plain_on_cuda(rng, dtype, sampling_ratio, channels):
    """The backward kernel against roi_align_backward_plain on the same
    CUDA inputs. Its f32 sums run in another order than the plain
    version's: float32 within 1e-5 of max |dF|; bf16 within one output
    rounding (1e-2 of max |dF|)."""
    _cuda_or_skip()
    feat, rois, valid, g = _grad_case(rng, 1 / 16, padded=True, c=channels)
    g = torch.from_numpy(g).cuda().to(dtype)
    args = (torch.from_numpy(rois).cuda(), feat.shape[0], feat.shape[1], 7, 1 / 16,
            sampling_ratio, 4, valid)
    before = roi_align_backward.kernel_launches
    got = roi_align_backward(g, *args)
    want = roi_align_backward_plain(g, *args)
    assert roi_align_backward.kernel_launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape == feat.shape
    rel = 1e-5 if dtype == torch.float32 else 1e-2
    atol = rel * want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


def _tile_case(rng, height=40, width=36, valid=(38, 33)):
    """ROIs that cross every boundary of the backward kernel's row bands
    and column tiles, one over the whole map, a few of one cell and a
    zero-area padding row last."""
    rois = []
    for b in range(ra.BWD_TILE, height, ra.BWD_TILE):
        x1 = rng.uniform(0, valid[1] * 8)
        rois.append([x1, (b - 1.5) * 16, x1 + rng.uniform(16, valid[1] * 8), (b + 2.5) * 16])
    for b in range(ra.BWD_TILE, width, ra.BWD_TILE):
        y1 = rng.uniform(0, valid[0] * 8)
        rois.append([(b - 0.7) * 16, y1, (b + 0.6) * 16, y1 + rng.uniform(16, valid[0] * 8)])
    rois.append([0.0, 0.0, valid[1] * 16 - 1.0, valid[0] * 16 - 1.0])
    for _ in range(4):
        x, y = rng.uniform(0, valid[1] * 16 - 12), rng.uniform(0, valid[0] * 16 - 12)
        rois.append([x, y, x + 10.0, y + 10.0])
    rois.append([0.0, 0.0, 0.0, 0.0])
    return np.asarray(rois, np.float32), (height, width), valid


@pytest.mark.cuda
@pytest.mark.parametrize("sampling_ratio", [0, 1])
@pytest.mark.parametrize("channels", [1100, 72], ids=["c1100", "c72"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_kernel_across_tiles_on_cuda(rng, dtype, channels, sampling_ratio):
    """A map of 10 x 9 tiles and two channel slices (1100 channels): ROIs
    across every tile boundary, a whole-map ROI, one-cell ROIs and a
    zero-area padding ROI with zero gradient. With one sample a bin, the
    wide bins leave untapped rows between their samples. The kernel agrees
    with the plain version as above and gives the same bits twice."""
    _cuda_or_skip()
    rois, (height, width), valid = _tile_case(rng)
    n = rois.shape[0]
    g = torch.from_numpy(rng.randn(n, 7, 7, channels).astype(np.float32)).cuda()
    g[-1] = 0.0
    g = g.to(dtype)
    args = (torch.from_numpy(rois).cuda(), height, width, 7, 1 / 16, sampling_ratio, 4, valid)
    got = roi_align_backward(g, *args)
    again = roi_align_backward(g, *args)
    want = roi_align_backward_plain(g, *args)
    rel = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=rel * want.float().abs().max().item())
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_kernel_zeroes_the_pad_on_cuda(rng, dtype):
    """The padded scale-1200 bucket, (76, 100) with a valid (75, 100), 64
    channels: dF is allocated uninitialised, so the kernel itself writes the
    pad, and it writes it as exactly zero."""
    _cuda_or_skip()
    shape, valid, n = (76, 100, 64), (75, 100), 256
    img_h, img_w = valid[0] * 16, valid[1] * 16
    x1, y1 = rng.uniform(0, img_w * 0.9, n), rng.uniform(0, img_h * 0.9, n)
    rois = np.stack([x1, y1, np.minimum(x1 + rng.uniform(8, img_w * 0.6, n), img_w - 1),
                     np.minimum(y1 + rng.uniform(8, img_h * 0.6, n), img_h - 1)], -1)
    rois[-1] = [img_w - 40.0, img_h - 40.0, img_w - 1.0, img_h - 1.0]  # at the valid edge
    g = torch.from_numpy(rng.randn(n, 7, 7, shape[2]).astype(np.float32)).cuda().to(dtype)
    args = (torch.from_numpy(rois.astype(np.float32)).cuda(), shape[0], shape[1], 7,
            1 / 16, 0, 4, valid)
    torch.full(shape, float("nan"), dtype=dtype, device="cuda")  # leave NaNs in the cache
    got = roi_align_backward(g, *args)
    want = roi_align_backward_plain(g, *args)
    assert not got[valid[0]:].any() and not got[:, valid[1]:].any()
    rel = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=rel * want.float().abs().max().item())


@pytest.mark.cuda
def test_kernel_launches_backward_on_cuda(rng):
    """Autograd through roi_align on CUDA features runs the forward kernel
    once and the backward kernel once."""
    _cuda_or_skip()
    feat, rois, valid = _case(rng, 1 / 16)
    feat = torch.from_numpy(feat).cuda().requires_grad_()
    fwd, bwd = roi_align.kernel_launches, roi_align_backward.kernel_launches
    out = roi_align(feat, torch.from_numpy(rois).cuda(), valid_hw=valid)
    out.sum().backward()
    assert roi_align.kernel_launches == fwd + 1
    assert roi_align_backward.kernel_launches == bwd + 1
    assert feat.grad.shape == feat.shape and torch.isfinite(feat.grad).all()
