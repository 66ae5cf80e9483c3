"""The CPU tests' body (``tiny.conv_body`` in the program): four stride-2
3x3 convs with bias and ReLU, 32 channels at stride 16."""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.model import Conv2d

CONV_BODY = "tiny"
FREEZE_KEY = None  # the program freezes none of it at any FREEZE_AT


class TinyConvBody(nn.Module):
    """Four stride-2 3x3 convs with bias and ReLU (the CPU tests' body)."""

    dim_out, stride = 32, 16
    CHANNELS = (8, 16, 32, 32)

    def __init__(self):
        super().__init__()
        ins = (3,) + self.CHANNELS[:-1]
        for i, (cin, cout) in enumerate(zip(ins, self.CHANNELS)):
            self.add_module(f"conv{i}", Conv2d(cin, cout, 3, stride=2, padding=1))

    def forward(self, x):
        for i in range(len(self.CHANNELS)):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return x

    @staticmethod
    def frozen(freeze_at):
        return []


Body = TinyConvBody


def feature_hw(h: int, w: int):
    """ceil(v / 16): four stride-2 convs that pad."""
    return -(-h // 16), -(-w // 16)
