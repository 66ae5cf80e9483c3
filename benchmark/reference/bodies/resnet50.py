"""ResNet-50-C4: torchvision's v1.5 ResNet-50 cut after layer3, 1024
channels at stride 16 (``resnet50.torch_resnet50`` in the program)."""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.model import Bottleneck, Conv2d, FrozenBatchNorm

CONV_BODY = "resnet50"
FREEZE_KEY = "ResNet.FREEZE_AT"


def _stage(inplanes, planes, blocks, stride):
    layers = [Bottleneck(inplanes, planes, stride, downsample=True)]
    layers += [Bottleneck(planes * 4, planes) for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class ResNet50C4(nn.Module):
    """ResNet-50 cut after layer3: 1024 channels at stride 16."""

    dim_out, stride = 1024, 16

    def __init__(self):
        super().__init__()
        self.res1 = nn.Sequential(Conv2d(3, 64, 7, stride=2, padding=3, bias=False),
                                  FrozenBatchNorm(64))
        self.res2 = _stage(64, 64, 3, 1)
        self.res3 = _stage(256, 128, 4, 2)
        self.res4 = _stage(512, 256, 6, 2)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.res1(x)), 3, 2, 1)
        return self.res4(self.res3(self.res2(x)))

    @staticmethod
    def frozen(freeze_at):
        return [f"res{i}" for i in range(1, freeze_at + 1)]


Body = ResNet50C4


def feature_hw(h: int, w: int):
    """ceil(v / 16): four stride-2 steps that pad."""
    return -(-h // 16), -(-w // 16)
