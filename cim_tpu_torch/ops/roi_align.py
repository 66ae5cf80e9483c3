"""RoIAlign forward: a plain PyTorch version and the hand-written CUDA kernel.

Semantics are those of cim_tpu.ops.roi_align (mmcv RoIAlign with
``aligned=True``): coordinates roi * spatial_scale - 0.5, no minimum ROI
size; ``sampling_ratio`` > 0 takes that many samples per bin and axis, 0
takes ceil(bin) of them capped at ``max_adaptive_grid``; bilinear taps snap
to the valid extent ``valid_hw`` of a zero-padded feature bucket.

:func:`roi_align` picks the implementation by the device of the features:
a CPU tensor takes :func:`roi_align_plain`, a CUDA tensor launches the
kernel of ``csrc/roi_align_fwd.cu`` (which replaces the TPU kernel
cim_tpu/ops/pallas/roi_align_kernel.py:_fwd_kernel), and anything else
raises. There is no backward kernel yet, so the CUDA path refuses features
that require a gradient.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from cim_tpu_torch.ops import _build

MAX_GRID = 64  # samples per bin and axis that the CUDA kernel holds (kMaxGrid)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _axis_taps(coord, valid: int):
    """Bilinear rows (or columns) and weights of sample coordinates along
    one axis, zeroed outside [-1, valid] (the CUDA kernel's border rule)."""
    in_range = (coord >= -1.0) & (coord <= valid)
    coord = coord.clamp(min=0.0)
    low = torch.floor(coord).to(torch.int64)
    at_edge = low >= valid - 1
    low = low.clamp(max=valid - 1)
    high = (low + 1).clamp(max=valid - 1)
    zero = torch.zeros_like(coord)
    frac = torch.where(at_edge, zero, coord - low.to(coord.dtype))
    w_low = torch.where(in_range, 1.0 - frac, zero)
    w_high = torch.where(in_range, frac, zero)
    return low, high, w_low, w_high


def roi_align_plain(
    features: torch.Tensor,
    rois: torch.Tensor,
    output_size: int = 7,
    spatial_scale: float = 1.0 / 16.0,
    sampling_ratio: int = 0,
    max_adaptive_grid: int = 2,
    valid_hw=None,
) -> torch.Tensor:
    """RoIAlign in gather form: features (H, W, C), rois (N, 4) xyxy in
    image coordinates -> (N, R, R, C) in the feature dtype.

    Sums run in float32 whatever the feature dtype, so on bf16 features
    this is the oracle the CUDA kernel is held to. valid_hw: optional
    (h, w) ints, the true extent inside a zero-padded bucket.
    """
    height, width, channels = features.shape
    vh, vw = (height, width) if valid_hw is None else (int(valid_hw[0]), int(valid_hw[1]))
    n = rois.shape[0]
    r = output_size
    dev = features.device
    feat = features.reshape(height * width, channels).float()
    rois = rois.float()

    x1 = rois[:, 0] * spatial_scale - 0.5
    y1 = rois[:, 1] * spatial_scale - 0.5
    # divide by a tensor: CUDA divides by a Python scalar as a product with
    # its reciprocal, one ulp off the true quotient the kernel and JAX take
    r_t = torch.full_like(x1, float(r))
    bin_w = (rois[:, 2] * spatial_scale - 0.5 - x1) / r_t
    bin_h = (rois[:, 3] * spatial_scale - 0.5 - y1) / r_t
    if sampling_ratio > 0:
        grid = sampling_ratio
        gh = torch.full((n,), grid, dtype=torch.int64, device=dev)
        gw = gh
    else:
        grid = max_adaptive_grid
        gh = torch.ceil(bin_h).clamp(1, grid).to(torch.int64)
        gw = torch.ceil(bin_w).clamp(1, grid).to(torch.int64)

    bins = torch.arange(r, dtype=torch.float32, device=dev)
    ys0 = y1[:, None] + bins[None, :] * bin_h[:, None]  # (N, R)
    xs0 = x1[:, None] + bins[None, :] * bin_w[:, None]
    step_h = (bin_h / gh.float())[:, None]
    step_w = (bin_w / gw.float())[:, None]

    acc = torch.zeros((n, r, r, channels), dtype=torch.float32, device=dev)
    for iy in range(grid):
        y = ys0 + (iy + 0.5) * step_h
        ylo, yhi, wylo, wyhi = _axis_taps(y, vh)
        y_on = (iy < gh)[:, None].float()
        for ix in range(grid):
            x = xs0 + (ix + 0.5) * step_w
            xlo, xhi, wxlo, wxhi = _axis_taps(x, vw)
            x_on = (ix < gw)[:, None].float()
            # (N, R, 1) rows x (N, 1, R) columns -> (N, R, R) taps
            for yy, wy in ((ylo, wylo * y_on), (yhi, wyhi * y_on)):
                for xx, wx in ((xlo, wxlo * x_on), (xhi, wxhi * x_on)):
                    idx = yy[:, :, None] * width + xx[:, None, :]
                    w = wy[:, :, None] * wx[:, None, :]
                    acc += feat[idx.reshape(-1)].reshape(n, r, r, channels) * w[..., None]
    count = (gh * gw).float()[:, None, None, None]
    return (acc / count).to(features.dtype)


@functools.cache
def _kernel():
    """The launcher of csrc/roi_align_fwd.cu, built on first use."""
    lib = _build.load("roi_align_fwd")
    fn = lib.roi_align_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # feat, rois, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n, h, w, c
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # vh, vw, r
        ctypes.c_float, ctypes.c_int, ctypes.c_int,  # scale, sampling_ratio, cap
        ctypes.c_int, ctypes.c_void_p,  # dtype code, stream
    ]
    return fn


def _roi_align_cuda(features, rois, output_size, spatial_scale,
                    sampling_ratio, max_adaptive_grid, valid_hw):
    if features.requires_grad:
        raise NotImplementedError(
            "roi_align on CUDA has no backward kernel yet; call it on "
            "features that do not require grad (e.g. under torch.no_grad())"
        )
    if features.dtype not in _DTYPE_CODES:
        raise TypeError(f"roi_align kernel takes float32 or bfloat16 features, got {features.dtype}")
    if features.dim() != 3 or not features.is_contiguous():
        raise ValueError(f"features must be a contiguous (H, W, C) tensor, got shape {tuple(features.shape)}")
    if rois.device != features.device or rois.dtype != torch.float32:
        raise ValueError("rois must be float32 on the features' device")
    if rois.dim() != 2 or rois.shape[1] != 4 or not rois.is_contiguous():
        raise ValueError(f"rois must be a contiguous (N, 4) tensor, got shape {tuple(rois.shape)}")
    grid = sampling_ratio if sampling_ratio > 0 else max_adaptive_grid
    if not 1 <= grid <= MAX_GRID:
        raise ValueError(f"samples per bin and axis must be in [1, {MAX_GRID}], got {grid}")
    height, width, channels = features.shape
    vh, vw = (height, width) if valid_hw is None else (int(valid_hw[0]), int(valid_hw[1]))
    if not (1 <= vh <= height and 1 <= vw <= width):
        raise ValueError(f"valid_hw {(vh, vw)} outside the feature map {(height, width)}")
    n = rois.shape[0]
    out = torch.empty((n, output_size, output_size, channels),
                      dtype=features.dtype, device=features.device)
    stream = torch.cuda.current_stream(features.device).cuda_stream
    err = _kernel()(
        features.data_ptr(), rois.data_ptr(), out.data_ptr(),
        n, height, width, channels, vh, vw, output_size,
        float(spatial_scale), int(sampling_ratio), int(max_adaptive_grid),
        _DTYPE_CODES[features.dtype], stream,
    )
    if err != 0:
        raise RuntimeError(f"roi_align_fwd kernel launch failed with CUDA error {err}")
    roi_align.kernel_launches += 1
    return out


def roi_align(
    features: torch.Tensor,
    rois: torch.Tensor,
    output_size: int = 7,
    spatial_scale: float = 1.0 / 16.0,
    sampling_ratio: int = 0,
    max_adaptive_grid: int = 2,
    valid_hw=None,
) -> torch.Tensor:
    """RoIAlign forward: features (H, W, C), rois (N, 4) -> (N, R, R, C).

    CPU tensors take :func:`roi_align_plain`; CUDA tensors launch the
    kernel (counted in ``roi_align.kernel_launches``) or raise.
    """
    if features.device.type == "cpu":
        return roi_align_plain(features, rois, output_size, spatial_scale,
                               sampling_ratio, max_adaptive_grid, valid_hw)
    if features.device.type == "cuda":
        return _roi_align_cuda(features, rois, output_size, spatial_scale,
                               sampling_ratio, max_adaptive_grid, valid_hw)
    raise ValueError(f"roi_align runs on cpu or cuda tensors, not {features.device}")


roi_align.kernel_launches = 0
