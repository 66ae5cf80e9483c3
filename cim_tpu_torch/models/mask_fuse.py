"""MaskFuse box head (port of cim_tpu/models/mask_fuse.py).

  box_x  = RoIAlign(features, rois)                  (N, 7, 7, C)
           (or RoIPool, ROI_XFORM_METHOD RoIPoolF)
  mask_x = box_x * proposal_mask                     7x7 COB mask gating
  y      = ReLU(Conv3x3(concat[box_x, mask_x]))      2C -> C
  seg_x  = ReLU(FC(ReLU(FC(flatten_CHW(y)))))        C*49 -> 4096 -> 4096

Names follow the reference checkpoint (``mask_branch.0``, ``seg_fc.0``,
``seg_fc.2``). With ``int8_eval`` the conv and ``seg_fc.0`` run as
dynamic w8a8 products (ops.quant) on the same parameters and ``seg_fc.2``
stays in the compute dtype, as in cim_tpu; eval only. cim_tpu's im2col
spelling of the conv (an XLA:CPU workaround) is not ported.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from cim_tpu_torch.models.layers import Conv2d, Linear
from cim_tpu_torch.ops.roi_align import roi_align, roi_pool
from cim_tpu_torch.utils.trace import span

ROI_METHODS = ("RoIAlign", "RoIPoolF")


class MaskFuse(nn.Module):
    def __init__(self, dim_in: int, spatial_scale: float, hidden_dim: int = 4096,
                 roi_size: int = 7, roi_method: str = "RoIAlign", sampling_ratio: int = 0,
                 max_adaptive_grid: int = 2, dtype=None, device=None):
        """roi_method: "RoIAlign" or "RoIPoolF" (cfg.FAST_RCNN.ROI_XFORM_METHOD).
        max_adaptive_grid: the RoIAlign grid cap, as the caller chose it
        (build_model follows cim_tpu's choice per config). dtype: compute
        dtype of the ROI transform, the conv and the FCs (None = the
        input's)."""
        super().__init__()
        if roi_method not in ROI_METHODS:
            raise ValueError(f"Unknown pooling method: {roi_method}")
        self.spatial_scale = spatial_scale
        self.roi_size = roi_size
        self.roi_method = roi_method
        self.sampling_ratio = sampling_ratio
        self.max_adaptive_grid = max_adaptive_grid
        self.dtype = dtype
        self.int8_eval = False
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
        Returns (N, hidden_dim) float32. A batch of images: features
        (B, H, W, C), rois (B, N, 4), masks (B, N, 7, 7) and valid_hw None
        or one extent per image -> (B, N, hidden_dim); the conv and the FCs
        run on the B * N rows at once."""
        with span("cim.mask_fuse"):
            if self.dtype is not None:
                features = features.to(self.dtype)
            if self.roi_method == "RoIAlign":
                box_x = roi_align(
                    features.contiguous(), rois, self.roi_size, self.spatial_scale,
                    self.sampling_ratio, self.max_adaptive_grid, valid_hw,
                )  # (N, R, R, C), or (B, N, R, R, C)
            else:
                box_x = roi_pool(features, rois, self.roi_size, self.spatial_scale,
                                 valid_hw=valid_hw)
            lead = box_x.shape[:-3]
            box_x = box_x.reshape(-1, *box_x.shape[-3:])
            mask_x = box_x * masks.reshape(-1, *masks.shape[-2:]).to(box_x.dtype)[..., None]
            x = torch.cat([box_x, mask_x], dim=-1).permute(0, 3, 1, 2)  # NCHW view of NHWC
            conv, fc1, fc2 = self.mask_branch[0], self.seg_fc[0], self.seg_fc[2]
            x = torch.relu(conv.forward_int8(x) if self.int8_eval else conv(x))
            # flatten the logical (C, H, W) order whatever the memory format, so
            # seg_fc.0 reads the reference's weight layout
            x = x.reshape(x.shape[0], -1)
            x = torch.relu(fc1.forward_int8(x) if self.int8_eval else fc1(x))
            x = torch.relu(fc2(x))
            return x.float().reshape(*lead, -1)
