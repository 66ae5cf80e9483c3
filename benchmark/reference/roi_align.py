"""RoIAlign in gather form, with autograd (plain PyTorch, float32 sums).

mmcv RoIAlign with ``aligned=True``: coordinates roi * spatial_scale - 0.5,
no minimum ROI size; sampling_ratio > 0 takes that many samples per bin
and axis, 0 takes ceil(bin) of them capped at ``cap``; a sample's
bilinear taps are zeroed outside [-1, extent] and snap to the map's edge.
The features are the map at its true extent, so the edge is the map's.
"""
from __future__ import annotations

import torch


def _axis(coord, extent: int):
    in_range = (coord >= -1.0) & (coord <= extent)
    coord = coord.clamp(min=0.0)
    low = torch.floor(coord).to(torch.int64)
    at_edge = low >= extent - 1
    low = low.clamp(max=extent - 1)
    high = (low + 1).clamp(max=extent - 1)
    zero = torch.zeros_like(coord)
    frac = torch.where(at_edge, zero, coord - low.to(coord.dtype))
    return low, high, torch.where(in_range, 1.0 - frac, zero), torch.where(in_range, frac, zero)


def sample_grid(rois, r, spatial_scale, sampling_ratio, cap):
    """(gh, gw, bin_h, bin_w, y0, x0) of each ROI: samples per bin and
    axis, bin sizes and the first bin's corner, in feature coordinates."""
    rois = rois.float()
    x1 = rois[:, 0] * spatial_scale - 0.5
    y1 = rois[:, 1] * spatial_scale - 0.5
    r_t = torch.full_like(x1, float(r))
    bin_w = (rois[:, 2] * spatial_scale - 0.5 - x1) / r_t
    bin_h = (rois[:, 3] * spatial_scale - 0.5 - y1) / r_t
    if sampling_ratio > 0:
        gh = torch.full_like(x1, sampling_ratio, dtype=torch.int64)
        gw = gh
    else:
        gh = torch.ceil(bin_h).clamp(1, cap).to(torch.int64)
        gw = torch.ceil(bin_w).clamp(1, cap).to(torch.int64)
    return gh, gw, bin_h, bin_w, y1, x1


def roi_align(feat, rois, r=7, spatial_scale=1.0 / 16, sampling_ratio=0, cap=4):
    """feat (h, w, C), rois (N, 4) xyxy image coordinates -> (N, r, r, C)
    float32, differentiable in feat."""
    h, w, c = feat.shape
    n = rois.shape[0]
    flat = feat.reshape(h * w, c).float()
    gh, gw, bin_h, bin_w, y1, x1 = sample_grid(rois, r, spatial_scale, sampling_ratio, cap)
    grid = int(gh.max().item()) if n else 1
    grid = max(grid, int(gw.max().item()) if n else 1)
    bins = torch.arange(r, dtype=torch.float32, device=rois.device)
    ys0 = y1[:, None] + bins[None, :] * bin_h[:, None]
    xs0 = x1[:, None] + bins[None, :] * bin_w[:, None]
    step_h = (bin_h / gh.float())[:, None]
    step_w = (bin_w / gw.float())[:, None]
    out = torch.zeros((n, r, r, c), dtype=torch.float32, device=feat.device)
    for iy in range(grid):
        ylo, yhi, wylo, wyhi = _axis(ys0 + (iy + 0.5) * step_h, h)
        y_on = (iy < gh)[:, None].float()
        for ix in range(grid):
            xlo, xhi, wxlo, wxhi = _axis(xs0 + (ix + 0.5) * step_w, w)
            x_on = (ix < gw)[:, None].float()
            for yy, wy in ((ylo, wylo * y_on), (yhi, wyhi * y_on)):
                for xx, wx in ((xlo, wxlo * x_on), (xhi, wxhi * x_on)):
                    idx = (yy[:, :, None] * w + xx[:, None, :]).reshape(-1)
                    wt = (wy[:, :, None] * wx[:, None, :])[..., None]
                    out = out + flat[idx].reshape(n, r, r, c) * wt
    return out / (gh * gw).float()[:, None, None, None]
