"""Shared model building blocks (port of cim_tpu/models/layers.py).

Layout is PyTorch's NCHW; on the GPU the backbone runs it in
``torch.channels_last`` memory, which is NHWC underneath. Parameters stay
float32 and are cast to the dtype of the input at each call, as flax casts
its float32 params to a module's ``dtype``: the input's dtype is the
compute dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in the dtype of its input."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Linear(nn.Linear):
    """nn.Linear computing in the dtype of its input."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class FrozenBatchNorm(nn.Module):
    """BatchNorm permanently in eval mode (reference resnet50.py:63-77):
    y = weight * (x - mean) / sqrt(var + eps) + bias, with the statistics
    in buffers that never update. The scale and offset are folded in
    float32 and applied in the input's dtype, as in cim_tpu."""

    def __init__(self, features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        off = self.bias - self.running_mean * inv
        shape = (1, -1, 1, 1)
        return x * inv.to(x.dtype).view(shape) + off.to(x.dtype).view(shape)


def mask_valid_hw(x: torch.Tensor, valid_hw):
    """Zero all positions at or beyond the valid extent of x (N, C, H, W).

    A zero-padded bucket's pad is not a fixed point of BN or conv-with-bias,
    so it is re-zeroed before every spatial conv and pool; otherwise it
    bleeds into the border of the valid region (cim_tpu/models/layers.py
    mask_valid_hw). valid_hw: None (no-op) or a pair of ints.
    """
    if valid_hw is None:
        return x
    h, w = x.shape[-2:]
    vh, vw = int(valid_hw[0]), int(valid_hw[1])
    if vh >= h and vw >= w:
        return x
    rows = torch.arange(h, device=x.device) < vh
    cols = torch.arange(w, device=x.device) < vw
    return x * (rows[:, None] & cols[None, :]).to(x.dtype)


def ceil_div_hw(valid_hw, k: int):
    """Valid extent after a stride-k op with 'same'-style padding
    (conv k3 s2 p1, conv k7 s2 p3, maxpool k3 s2 p1): ceil(v / k)."""
    if valid_hw is None:
        return None
    return ((valid_hw[0] + k - 1) // k, (valid_hw[1] + k - 1) // k)


@torch.no_grad()
def torch_default_init_(model: nn.Module, generator: torch.Generator):
    """PyTorch's default init of every Conv2d and Linear, drawn from
    ``generator``: weight and bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    (kaiming_uniform with a = sqrt(5), as cim_tpu's torch_kaiming_uniform)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            for p in (m.weight, m.bias):
                if p is not None:
                    u = torch.rand(p.shape, generator=generator,
                                   device=generator.device, dtype=p.dtype)
                    p.copy_((u * 2.0 - 1.0) * bound)
