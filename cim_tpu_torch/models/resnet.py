"""ResNet-50-C4 backbone (port of cim_tpu/models/resnet.py).

The torchvision resnet50 trunk cut after layer3 (res4): 1024 channels at
stride 16, BatchNorm frozen. Module names follow the reference checkpoint
(``res1.0`` conv, ``res1.1`` BN, ``res2``..``res4`` = layer1..layer3), so
its state_dict loads unchanged. The space-to-depth stem of cim_tpu is a
TPU-only re-layout and is not ported.
"""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from cim_tpu_torch.models.layers import (
    Conv2d,
    FrozenBatchNorm,
    ceil_div_hw,
    mask_valid_hw,
)


class Bottleneck(nn.Module):
    """torchvision-v1.5 bottleneck: 1x1 -> 3x3 (stride) -> 1x1, x4 width."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, device=None):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False, device=device)
        self.bn1 = FrozenBatchNorm(planes, device=device)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1,
                            bias=False, device=device)
        self.bn2 = FrozenBatchNorm(planes, device=device)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False, device=device)
        self.bn3 = FrozenBatchNorm(planes * 4, device=device)
        self.downsample = (
            nn.Sequential(
                Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False,
                       device=device),
                FrozenBatchNorm(planes * 4, device=device),
            )
            if downsample else None
        )

    def forward(self, x, valid_hw=None):
        out = F.relu(self.bn1(self.conv1(x)))
        # conv2 is the only spatial conv: zero the pad that bn1 re-polluted
        out = mask_valid_hw(out, valid_hw)
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


def _stage(inplanes: int, planes: int, blocks: int, stride: int, device):
    layers = [Bottleneck(inplanes, planes, stride, downsample=True, device=device)]
    layers += [Bottleneck(planes * 4, planes, device=device) for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class ResNet50C4(nn.Module):
    """Stages res1..res4; returns the stride-16, 1024-channel feature map."""

    dim_out = 1024
    spatial_scale = 1.0 / 16.0

    def __init__(self, block_counts=(3, 4, 6), device=None):
        super().__init__()
        self.res1 = nn.Sequential(
            Conv2d(3, 64, 7, stride=2, padding=3, bias=False, device=device),
            FrozenBatchNorm(64, device=device),
        )
        self.res2 = _stage(64, 64, block_counts[0], 1, device)
        self.res3 = _stage(256, 128, block_counts[1], 2, device)
        self.res4 = _stage(512, 256, block_counts[2], 2, device)

    def forward(self, x, valid_hw=None):
        """x: (1, 3, H, W); valid_hw: optional (h, w) image extent inside a
        zero-padded bucket. The image pad is exact zeros, so the bias-free
        stem conv needs no mask; every later spatial op does."""
        x = F.relu(self.res1(x))
        valid_hw = ceil_div_hw(valid_hw, 2)
        # torch max pooling pads with -inf, as cim_tpu's max_pool_torch does
        x = F.max_pool2d(mask_valid_hw(x, valid_hw), 3, 2, 1)
        valid_hw = ceil_div_hw(valid_hw, 2)
        for stage in (self.res2, self.res3, self.res4):
            for i, block in enumerate(stage):
                x = block(x, valid_hw)
                if i == 0 and block.conv2.stride[0] != 1:
                    valid_hw = ceil_div_hw(valid_hw, 2)
        # RoIAlign downstream must read clean zeros in the pad
        return mask_valid_hw(x, valid_hw)

    @staticmethod
    def feature_valid_hw(im_hw):
        """Valid feature extent for an (h, w) image: ceil(v / 16)."""
        if im_hw is None:
            return None
        return ((im_hw[0] + 15) // 16, (im_hw[1] + 15) // 16)
