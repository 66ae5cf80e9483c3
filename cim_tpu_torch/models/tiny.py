"""Tiny conv body for the CPU tests (port of cim_tpu/models/tiny.py).

Stride-16, 32-channel feature map from four stride-2 3x3 convs with bias,
each followed by ReLU, registered as ``tiny.conv_body``. It lets the
train-step tests run the whole pipeline at a size a CPU takes in seconds.
"""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from cim_tpu_torch.models.layers import Conv2d, ceil_div_hw, mask_valid_hw

CHANNELS = (8, 16, 32, 32)


class TinyConvBody(nn.Module):
    dim_out = 32
    spatial_scale = 1.0 / 16.0

    def __init__(self, device=None):
        super().__init__()
        ins = (3,) + CHANNELS[:-1]
        for i, (cin, cout) in enumerate(zip(ins, CHANNELS)):
            self.add_module(f"conv{i}", Conv2d(cin, cout, 3, stride=2, padding=1, device=device))

    def forward(self, x, valid_hw=None):
        for i in range(len(CHANNELS)):
            x = mask_valid_hw(x, valid_hw)  # conv bias pollutes the pad
            x = F.relu(getattr(self, f"conv{i}")(x))
            valid_hw = ceil_div_hw(valid_hw, 2)
        return mask_valid_hw(x, valid_hw)

    @staticmethod
    def feature_valid_hw(im_hw):
        if im_hw is None:
            return None
        return ((im_hw[0] + 15) // 16, (im_hw[1] + 15) // 16)
