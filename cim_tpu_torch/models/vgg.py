"""Dilated VGG-16 backbone (port of cim_tpu/models/vgg.py).

13 biased 3x3 convs in five groups, max pooling k2 s2 after conv1-conv3
only (stride 8), conv5 with dilation 2 and padding 2: 512 channels at
stride 8. Module names follow the reference's dilated_conv5_body: each
group is an ``nn.Sequential`` of conv, ReLU (and the pool), so the first
conv is ``conv1.0`` and conv5's last ``conv5.4``.
"""
from __future__ import annotations

import torch.nn as nn

from cim_tpu_torch.models.layers import Conv2d, floor_div_hw, mask_valid_hw

GROUPS = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))
POOLED = 3  # groups conv1..conv3 end in a pool


class DilatedVGG16(nn.Module):
    dim_out = 512
    spatial_scale = 1.0 / 8.0

    def __init__(self, device=None):
        super().__init__()
        cin = 3
        for g, chans in enumerate(GROUPS, 1):
            dilation = 2 if g == 5 else 1
            layers = []
            for cout in chans:
                layers += [Conv2d(cin, cout, 3, padding=dilation, dilation=dilation,
                                  device=device), nn.ReLU()]
                cin = cout
            if g <= POOLED:
                layers.append(nn.MaxPool2d(2, 2))
            self.add_module(f"conv{g}", nn.Sequential(*layers))

    def forward(self, x, valid_hw=None):
        """x: (B, 3, H, W); valid_hw: optional (h, w) image extent inside a
        zero-padded bucket, or one such pair per image. Every conv has a
        bias, so the pad drifts: it is re-zeroed before each conv and pool."""
        for g in range(1, len(GROUPS) + 1):
            for layer in getattr(self, f"conv{g}"):
                if isinstance(layer, nn.ReLU):
                    x = layer(x)
                    continue
                x = layer(mask_valid_hw(x, valid_hw))
                if isinstance(layer, nn.MaxPool2d):
                    # k2 s2 p0 drops a trailing odd row
                    valid_hw = floor_div_hw(valid_hw, 2)
        return mask_valid_hw(x, valid_hw)

    @staticmethod
    def feature_valid_hw(im_hw):
        """Valid feature extent for an (h, w) image, or for each image's:
        floor(v / 8)."""
        return floor_div_hw(im_hw, 8)


def frozen_param_paths(freeze_at: int):
    """Module paths under the body that VGG.FREEZE_AT freezes."""
    return [f"conv{i}" for i in range(1, freeze_at + 1)]
