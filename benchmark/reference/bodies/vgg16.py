"""Dilated VGG-16: conv5 dilated 2 and no pool after it, 512 channels at
stride 8 (``vgg16.dilated_conv5_body`` in the program)."""
from __future__ import annotations

import torch.nn as nn

from benchmark.reference.model import Conv2d

CONV_BODY = "vgg16"
FREEZE_KEY = "VGG.FREEZE_AT"


class DilatedVGG16(nn.Module):
    """13 biased 3x3 convs, pools after groups 1-3, conv5 dilated 2: 512
    channels at stride 8."""

    dim_out, stride = 512, 8
    GROUPS = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))

    def __init__(self):
        super().__init__()
        cin = 3
        for g, chans in enumerate(self.GROUPS, 1):
            d = 2 if g == 5 else 1
            layers = []
            for cout in chans:
                layers += [Conv2d(cin, cout, 3, padding=d, dilation=d), nn.ReLU()]
                cin = cout
            if g <= 3:
                layers.append(nn.MaxPool2d(2, 2))
            self.add_module(f"conv{g}", nn.Sequential(*layers))

    def forward(self, x):
        for g in range(1, 6):
            x = getattr(self, f"conv{g}")(x)
        return x

    @staticmethod
    def frozen(freeze_at):
        return [f"conv{i}" for i in range(1, freeze_at + 1)]


Body = DilatedVGG16


def feature_hw(h: int, w: int):
    """floor(v / 8): three k2 s2 pools."""
    return h // 8, w // 8
