"""MaskFuse box head (port of cim_tpu/models/mask_fuse.py, RoIAlign only).

  box_x  = RoIAlign(features, rois)                  (N, 7, 7, C)
  mask_x = box_x * proposal_mask                     7x7 COB mask gating
  y      = ReLU(Conv3x3(concat[box_x, mask_x]))      2C -> C
  seg_x  = ReLU(FC(ReLU(FC(flatten_CHW(y)))))        C*49 -> 4096 -> 4096

Names follow the reference checkpoint (``mask_branch.0``, ``seg_fc.0``,
``seg_fc.2``). The int8 and im2col variants of cim_tpu are not ported.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from cim_tpu_torch.models.layers import Conv2d, Linear
from cim_tpu_torch.ops.roi_align import roi_align


class MaskFuse(nn.Module):
    def __init__(self, dim_in: int, spatial_scale: float, hidden_dim: int = 4096,
                 roi_size: int = 7, sampling_ratio: int = 0,
                 max_adaptive_grid: int = 2, dtype=None, device=None):
        """max_adaptive_grid: the RoIAlign grid cap, as the caller chose it
        (build_model follows cim_tpu's choice per config). dtype: compute
        dtype of RoIAlign, the conv and the FCs (None = the input's)."""
        super().__init__()
        self.spatial_scale = spatial_scale
        self.roi_size = roi_size
        self.sampling_ratio = sampling_ratio
        self.max_adaptive_grid = max_adaptive_grid
        self.dtype = dtype
        self.mask_branch = nn.Sequential(
            Conv2d(dim_in * 2, dim_in, 3, padding=1, device=device), nn.ReLU()
        )
        self.seg_fc = nn.Sequential(
            Linear(dim_in * roi_size ** 2, hidden_dim, device=device), nn.ReLU(),
            Linear(hidden_dim, hidden_dim, device=device), nn.ReLU(),
        )

    def forward(self, features, rois, masks, valid_hw=None):
        """features: (H, W, C); rois: (N, 4) image coordinates; masks:
        (N, 7, 7); valid_hw: optional true feature extent in the bucket.
        Returns (N, hidden_dim) float32."""
        if self.dtype is not None:
            features = features.to(self.dtype)
        box_x = roi_align(
            features.contiguous(), rois, self.roi_size, self.spatial_scale,
            self.sampling_ratio, self.max_adaptive_grid, valid_hw,
        )  # (N, R, R, C)
        mask_x = box_x * masks.to(box_x.dtype)[..., None]
        x = torch.cat([box_x, mask_x], dim=-1).permute(0, 3, 1, 2)  # NCHW view of NHWC
        x = self.mask_branch(x)
        # flatten the logical (C, H, W) order whatever the memory format, so
        # seg_fc.0 reads the reference's weight layout
        x = self.seg_fc(x.reshape(x.shape[0], -1))
        return x.float()
