"""RoIAlign: plain PyTorch versions and the hand-written CUDA kernels.

Semantics are those of cim_tpu.ops.roi_align (mmcv RoIAlign with
``aligned=True``): coordinates roi * spatial_scale - 0.5, no minimum ROI
size; ``sampling_ratio`` > 0 takes that many samples per bin and axis, 0
takes ceil(bin) of them capped at ``max_adaptive_grid``; bilinear taps snap
to the valid extent ``valid_hw`` of a zero-padded feature bucket.

:func:`roi_align` runs through :class:`RoIAlignFunction` and picks the
implementation by the device of the features: a CPU tensor takes
:func:`roi_align_plain` forward and :func:`roi_align_backward_plain`
backward; a CUDA tensor launches the kernels of ``csrc/roi_align_fwd.cu``
and ``csrc/roi_align_bwd.cu`` (which replace the TPU kernels
cim_tpu/ops/pallas/roi_align_kernel.py:_fwd_kernel and _bwd_kernel); and
anything else raises. The rois and the valid extent get no gradient, as
in cim_tpu.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from cim_tpu_torch.ops import _build

MAX_GRID = 64  # samples per bin and axis that the CUDA kernels hold (kMaxGrid)

# the forward kernel's channel slices a cell, in bytes (csrc/roi_align_fwd.cu)
FWD_MAX_CELL_BYTES = 128
FWD_MIN_CELL_BYTES = 8

# the backward kernel's tiles (csrc/roi_align_bwd.cu)
BWD_MAX_BINS = 7  # bins per axis its tap tables hold (kMaxR)
BWD_ENTRY_WORDS = 8  # 32-bit words of a tap-table entry (kEntry)
BWD_TILE = 4  # a block's tile of dF: BWD_TILE x BWD_TILE cells (kTile)
BWD_SLICE = 1024  # channels of a block's slice (kSlice)
BWD_SLOT_BYTES = 28 * 1024  # bins of g a stage holds (kSlotBytes)
BWD_STAGES = 3  # cp.async ring depth (kStages)
BWD_LIST_CAP = 2048  # ROI entries a block lists at a time (kListCap)
BWD_BLOCKS_PER_SM = 2  # blocks an SM at the least, made up by splitting the ROIs

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}


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


def _taps(rois, width, vh, vw, output_size, spatial_scale, sampling_ratio,
          max_adaptive_grid):
    """The bilinear taps of every ROI bin: returns (taps, count) where taps
    yields (idx, w) per (sample, corner), idx the flat feature index
    y * width + x and w the weight, both (N, R, R), and count (N,) is the
    number of samples of each ROI's bins (gh * gw)."""
    n = rois.shape[0]
    r = output_size
    dev = rois.device
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

    def taps():
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
                        yield (yy[:, :, None] * width + xx[:, None, :],
                               wy[:, :, None] * wx[:, None, :])

    return taps(), (gh * gw).float()


def _valid(height, width, valid_hw):
    return (height, width) if valid_hw is None else (int(valid_hw[0]), int(valid_hw[1]))


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
    vh, vw = _valid(height, width, valid_hw)
    n, r = rois.shape[0], output_size
    feat = features.reshape(height * width, channels).float()
    taps, count = _taps(rois, width, vh, vw, r, spatial_scale, sampling_ratio,
                        max_adaptive_grid)
    acc = torch.zeros((n, r, r, channels), dtype=torch.float32, device=features.device)
    for idx, w in taps:
        acc += feat[idx.reshape(-1)].reshape(n, r, r, channels) * w[..., None]
    return (acc / count[:, None, None, None]).to(features.dtype)


def roi_align_backward_plain(
    grad: torch.Tensor,
    rois: torch.Tensor,
    height: int,
    width: int,
    output_size: int = 7,
    spatial_scale: float = 1.0 / 16.0,
    sampling_ratio: int = 0,
    max_adaptive_grid: int = 2,
    valid_hw=None,
) -> torch.Tensor:
    """The gradient of :func:`roi_align_plain` with respect to its features:
    grad (N, R, R, C) -> (H, W, C) in grad's dtype (the features' dtype).

    Scatter form of the same taps as the forward, one index_add_ per
    (sample, corner); sums run in float32 and round once to grad's dtype,
    so on bf16 this is the oracle the CUDA kernel is held to.
    """
    channels = grad.shape[-1]
    vh, vw = _valid(height, width, valid_hw)
    taps, count = _taps(rois, width, vh, vw, output_size, spatial_scale,
                        sampling_ratio, max_adaptive_grid)
    g = grad.float() / count[:, None, None, None]
    dfeat = torch.zeros((height * width, channels), dtype=torch.float32, device=grad.device)
    for idx, w in taps:
        dfeat.index_add_(0, idx.reshape(-1), (g * w[..., None]).reshape(-1, channels))
    return dfeat.reshape(height, width, channels).to(grad.dtype)


# the arguments each kernel takes after the common ones: its scratch, then its plan
_PLAN_ARGTYPES = {
    "roi_align_fwd": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int],  # cs, groups, smem
    "roi_align_bwd": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int],  # splits, smem
}


def _load(name: str):
    """The launcher of csrc/<name>.cu, built on first use; both kernels
    take the same arguments, then each its scratch and plan."""
    fn = getattr(_build.load(name), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # in, rois, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n, h, w, c
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # vh, vw, r
        ctypes.c_float, ctypes.c_int, ctypes.c_int,  # scale, sampling_ratio, cap
        ctypes.c_int, ctypes.c_void_p,  # dtype code, stream
        *_PLAN_ARGTYPES[name],
    ]
    return fn


_kernel = functools.cache(_load)


def _check_cuda_args(what, t, rois, sampling_ratio, max_adaptive_grid, height,
                     width, valid_hw):
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: the tensor must be contiguous")
    if rois.device != t.device or rois.dtype != torch.float32:
        raise ValueError("rois must be float32 on the features' device")
    if rois.dim() != 2 or rois.shape[1] != 4 or not rois.is_contiguous():
        raise ValueError(f"rois must be a contiguous (N, 4) tensor, got shape {tuple(rois.shape)}")
    grid = sampling_ratio if sampling_ratio > 0 else max_adaptive_grid
    if not 1 <= grid <= MAX_GRID:
        raise ValueError(f"samples per bin and axis must be in [1, {MAX_GRID}], got {grid}")
    vh, vw = _valid(height, width, valid_hw)
    if not (1 <= vh <= height and 1 <= vw <= width):
        raise ValueError(f"valid_hw {(vh, vw)} outside the feature map {(height, width)}")
    return vh, vw


def _launch(name, src, rois, out, height, width, channels, vh, vw, output_size,
            spatial_scale, sampling_ratio, max_adaptive_grid, extra=()):
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = _kernel(name)(
        src.data_ptr(), rois.data_ptr(), out.data_ptr(),
        rois.shape[0], height, width, channels, vh, vw, output_size,
        float(spatial_scale), int(sampling_ratio), int(max_adaptive_grid),
        _DTYPE_CODES[src.dtype], stream, *extra,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


class FwdPlan(NamedTuple):
    """How the forward kernel cuts the feature map's channels and the ROIs
    into blocks."""
    cs: int  # channels of a block's slice
    groups: int  # groups of ROIs: ROI n goes to group n % groups
    blocks: int  # slices x groups
    smem: int  # dynamic shared memory of a block, bytes: the slice of the valid map


def _fwd_plan(vh: int, vw: int, channels: int, elem_bytes: int, smem_bytes: int,
              sms: int) -> FwdPlan:
    """The forward kernel's plan for a valid extent (vh, vw) of a map of
    ``channels`` channels of ``elem_bytes`` bytes, on a card with ``sms``
    multiprocessors and ``smem_bytes`` of opt-in shared memory a block.

    A block holds a channel slice of every valid cell in shared memory: the
    widest slice, a power of two of FWD_MIN_CELL_BYTES to FWD_MAX_CELL_BYTES
    bytes a cell, that fits, and no wider than the channels need. Slices
    cut the channels; the ROIs are dealt round into groups (ROI n to group
    n % groups), so that slices x groups blocks fill the card in one wave.
    A block has 1024 threads, whose registers fill a multiprocessor, so an
    SM runs one block at a time.
    """
    cells = vh * vw
    cs = FWD_MAX_CELL_BYTES // elem_bytes
    while cs * elem_bytes > FWD_MIN_CELL_BYTES and (
            cs // 2 >= channels or cells * cs * elem_bytes > smem_bytes):
        cs //= 2
    smem = cells * cs * elem_bytes
    if smem > smem_bytes:
        raise ValueError(f"the forward kernel's narrowest slice of the valid {vh}x{vw} map, "
                         f"{smem} bytes, exceeds the card's {smem_bytes} bytes of shared "
                         f"memory a block")
    slices = -(-channels // cs)
    groups = max(1, sms // slices)
    return FwdPlan(cs, groups, slices * groups, smem)


def _fwd_scratch_words(n: int, output_size: int, sampling_ratio: int,
                       max_adaptive_grid: int) -> int:
    """32-bit words of the forward kernel's tap tables: per ROI, axis and
    bin, a count and up to two taps per sample, each a (cell, weight)
    pair."""
    grid = sampling_ratio if sampling_ratio > 0 else max_adaptive_grid
    return n * 2 * output_size * (2 * grid + 1) * 2


class BwdPlan(NamedTuple):
    """How the backward kernel cuts dF (H, W, C) into blocks."""
    cs: int  # channels of a block's slice
    band_rows: int  # rows of a block's tile
    tile_cols: int  # columns of a block's tile
    splits: int  # runs of the ROIs summed apart, then added up in order
    blocks: int
    smem: int  # dynamic shared memory of a block, bytes


def _bwd_plan(height: int, width: int, channels: int, smem_bytes: int, sms: int,
              output_size: int = 7) -> BwdPlan:
    """The backward kernel's plan for dF (height, width, channels) on a card
    with ``sms`` multiprocessors and ``smem_bytes`` of opt-in shared memory
    a block.

    A block sums a BWD_TILE x BWD_TILE tile of cells over a slice of
    BWD_SLICE channels in registers; tiles and slices cut dF. When there
    are fewer of them than BWD_BLOCKS_PER_SM a multiprocessor, the ROIs are
    split into runs, one block each, so that the card fills. A block's
    shared memory holds its list of ROIs and BWD_STAGES stages of one
    ROI's bins of g and its tap-table entries for the tile.
    """
    if not 1 <= output_size <= BWD_MAX_BINS:
        raise ValueError(f"the backward kernel holds 1 to {BWD_MAX_BINS} bins per axis, "
                         f"got output_size {output_size}")
    tiles = -(-channels // BWD_SLICE) * -(-height // BWD_TILE) * -(-width // BWD_TILE)
    splits = -(-BWD_BLOCKS_PER_SM * sms // tiles)
    smem = BWD_LIST_CAP * 8 + BWD_STAGES * (BWD_SLOT_BYTES + 2 * BWD_TILE * BWD_ENTRY_WORDS * 4)
    if smem > smem_bytes:
        raise ValueError(f"the backward kernel's {smem} bytes of shared memory a block "
                         f"exceed the card's {smem_bytes}")
    return BwdPlan(BWD_SLICE, BWD_TILE, BWD_TILE, splits, splits * tiles, smem)


def _bwd_scratch_words(n: int, height: int, width: int, channels: int, plan: BwdPlan) -> int:
    """32-bit words of the backward kernel's scratch: the tap tables (per
    ROI its rectangle, an entry per row and per column), then the splits'
    partial sums if there is more than one."""
    words = n * (4 + (height + width) * BWD_ENTRY_WORDS)
    return words + (plan.splits * height * width * channels if plan.splits > 1 else 0)


@functools.cache
def _device_limits(device: torch.device):
    """(opt-in shared memory a block, multiprocessors) of a CUDA device."""
    props = torch.cuda.get_device_properties(device)
    return props.shared_memory_per_block_optin, props.multi_processor_count


def fwd_launch_plan(vh: int, vw: int, channels: int, dtype: torch.dtype, device) -> FwdPlan:
    """:func:`_fwd_plan` for the CUDA device the forward kernel runs on."""
    return _fwd_plan(vh, vw, channels, _ELEM_BYTES[dtype], *_device_limits(torch.device(device)))


def bwd_launch_plan(height: int, width: int, channels: int, device,
                    output_size: int = 7) -> BwdPlan:
    """:func:`_bwd_plan` for the CUDA device the backward kernel runs on."""
    return _bwd_plan(height, width, channels, *_device_limits(torch.device(device)),
                     output_size)


def _roi_align_cuda(features, rois, output_size, spatial_scale,
                    sampling_ratio, max_adaptive_grid, valid_hw):
    if features.dim() != 3:
        raise ValueError(f"features must be an (H, W, C) tensor, got shape {tuple(features.shape)}")
    height, width, channels = features.shape
    vh, vw = _check_cuda_args("roi_align_fwd", features, rois, sampling_ratio,
                              max_adaptive_grid, height, width, valid_hw)
    plan = fwd_launch_plan(vh, vw, channels, features.dtype, features.device)
    scratch = torch.empty(_fwd_scratch_words(rois.shape[0], output_size, sampling_ratio,
                                             max_adaptive_grid),
                          dtype=torch.int32, device=features.device)
    # every element is written by the kernel, once, in the features' dtype
    out = torch.empty((rois.shape[0], output_size, output_size, channels),
                      dtype=features.dtype, device=features.device)
    _launch("roi_align_fwd", features, rois, out, height, width, channels, vh, vw,
            output_size, spatial_scale, sampling_ratio, max_adaptive_grid,
            extra=(scratch.data_ptr(), plan.cs, plan.groups, plan.smem))
    roi_align.kernel_launches += 1
    return out


def _roi_align_backward_cuda(grad, rois, height, width, output_size,
                             spatial_scale, sampling_ratio, max_adaptive_grid,
                             valid_hw):
    n, channels = rois.shape[0], grad.shape[-1]
    if tuple(grad.shape) != (n, output_size, output_size, channels):
        raise ValueError(f"grad must be (N, R, R, C) = ({n}, {output_size}, "
                         f"{output_size}, C), got {tuple(grad.shape)}")
    grad = grad.contiguous()
    vh, vw = _check_cuda_args("roi_align_bwd", grad, rois, sampling_ratio,
                              max_adaptive_grid, height, width, valid_hw)
    plan = bwd_launch_plan(height, width, channels, grad.device, output_size)
    scratch = torch.empty(_bwd_scratch_words(n, height, width, channels, plan),
                          dtype=torch.int32, device=grad.device)
    # every element is written by the kernel, once, in grad's dtype
    dfeat = torch.empty((height, width, channels), dtype=grad.dtype, device=grad.device)
    _launch("roi_align_bwd", grad, rois, dfeat, height, width, channels, vh, vw,
            output_size, spatial_scale, sampling_ratio, max_adaptive_grid,
            extra=(scratch.data_ptr(), plan.splits, plan.smem))
    roi_align_backward.kernel_launches += 1
    return dfeat


def _device_type(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"roi_align runs on cpu or cuda tensors, not {t.device}")
    return t.device.type


def roi_align_backward(
    grad: torch.Tensor,
    rois: torch.Tensor,
    height: int,
    width: int,
    output_size: int = 7,
    spatial_scale: float = 1.0 / 16.0,
    sampling_ratio: int = 0,
    max_adaptive_grid: int = 2,
    valid_hw=None,
) -> torch.Tensor:
    """RoIAlign backward: grad (N, R, R, C) -> d features (H, W, C).

    CPU tensors take :func:`roi_align_backward_plain`; CUDA tensors launch
    the kernel (counted in ``roi_align_backward.kernel_launches``) or raise.
    """
    args = (grad, rois, height, width, output_size, spatial_scale,
            sampling_ratio, max_adaptive_grid, valid_hw)
    if _device_type(grad) == "cpu":
        return roi_align_backward_plain(*args)
    return _roi_align_backward_cuda(*args)


class RoIAlignFunction(torch.autograd.Function):
    """RoIAlign with its backward: the CUDA kernels on CUDA tensors, the
    plain versions on CPU tensors (counterpart of cim_tpu's custom_vjp
    around roi_align_pallas). Only the features get a gradient."""

    @staticmethod
    def forward(ctx, features, rois, output_size, spatial_scale,
                sampling_ratio, max_adaptive_grid, valid_hw):
        ctx.save_for_backward(rois)
        ctx.args = (features.shape[0], features.shape[1], output_size,
                    spatial_scale, sampling_ratio, max_adaptive_grid, valid_hw)
        args = (features, rois, output_size, spatial_scale, sampling_ratio,
                max_adaptive_grid, valid_hw)
        if features.device.type == "cpu":
            return roi_align_plain(*args)
        return _roi_align_cuda(*args)

    @staticmethod
    def backward(ctx, grad):
        (rois,) = ctx.saved_tensors
        dfeat = roi_align_backward(grad, rois, *ctx.args) if ctx.needs_input_grad[0] else None
        return dfeat, None, None, None, None, None, None


def roi_align(
    features: torch.Tensor,
    rois: torch.Tensor,
    output_size: int = 7,
    spatial_scale: float = 1.0 / 16.0,
    sampling_ratio: int = 0,
    max_adaptive_grid: int = 2,
    valid_hw=None,
) -> torch.Tensor:
    """RoIAlign: features (H, W, C), rois (N, 4) -> (N, R, R, C), with a
    gradient for the features.

    CPU tensors take the plain versions; CUDA tensors launch the kernels
    (counted in ``roi_align.kernel_launches`` and
    ``roi_align_backward.kernel_launches``) or raise.
    """
    _device_type(features)
    return RoIAlignFunction.apply(features, rois, output_size, spatial_scale,
                                  sampling_ratio, max_adaptive_grid, valid_hw)


roi_align.kernel_launches = 0
roi_align_backward.kernel_launches = 0
