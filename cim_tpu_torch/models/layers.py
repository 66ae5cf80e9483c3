"""Shared model building blocks (port of cim_tpu/models/layers.py).

Layout is PyTorch's NCHW; on the GPU the backbone runs it in
``torch.channels_last`` memory, which is NHWC underneath. Parameters stay
float32 and are cast to the dtype of the input at each call, as flax casts
its float32 params to a module's ``dtype``: the input's dtype is the
compute dtype.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from cim_tpu_torch.ops.quant import int8_conv_nhwc, int8_dense


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in the dtype of its input; forward_int8 is its
    dynamic int8 form on the same parameters."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)

    def forward_int8(self, x):
        """The conv as w8a8 products (ops.quant.int8_conv_nhwc; cim_tpu's
        _Int8Conv), stride 1 with symmetric padding and a bias only; x
        (N, C, H, W), NHWC in memory -> the input's dtype, NHWC in memory."""
        if (self.stride != (1, 1) or self.dilation != (1, 1) or self.groups != 1
                or self.bias is None or self.padding[0] != self.padding[1]):
            raise ValueError("the int8 conv is stride 1, undilated, ungrouped, with a bias "
                             "and the same padding on both axes")
        y = int8_conv_nhwc(x.permute(0, 2, 3, 1), self.weight, self.bias, self.padding[0])
        return y.to(x.dtype).permute(0, 3, 1, 2)


class Linear(nn.Linear):
    """nn.Linear computing in the dtype of its input; forward_int8 is its
    dynamic int8 form on the same parameters."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))

    def forward_int8(self, x):
        """x @ W^T + b as w8a8 products (ops.quant.int8_dense; cim_tpu's
        _Int8Dense), in the input's dtype."""
        return int8_dense(x, self.weight, self.bias).to(x.dtype)


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


def is_per_image(valid_hw) -> bool:
    """True where valid_hw holds one (h, w) pair per image of a batch, not
    one pair."""
    return valid_hw is not None and len(valid_hw) > 0 and isinstance(valid_hw[0], (tuple, list))


@functools.lru_cache(maxsize=64)
def _batch_mask(h: int, w: int, extents: tuple, device: torch.device, dtype: torch.dtype):
    """(B, 1, h, w) mask, 1 inside each image's extent and 0 beyond, filled
    on the device (a copy from host memory would wait for the device's
    queue); kept for the passes of a stack, which repeat it."""
    mask = torch.zeros((len(extents), 1, h, w), device=device, dtype=dtype)
    for m, (vh, vw) in zip(mask, extents):
        m[:, :vh, :vw] = 1
    return mask


def mask_valid_hw(x: torch.Tensor, valid_hw):
    """Zero all positions at or beyond the valid extent of x (N, C, H, W).

    A zero-padded bucket's pad is not a fixed point of BN or conv-with-bias,
    so it is re-zeroed before every spatial conv and pool; otherwise it
    bleeds into the border of the valid region (cim_tpu/models/layers.py
    mask_valid_hw). valid_hw: None (no-op), a pair of ints, or one pair per
    image of the batch x (the extents of a stack of images, as cim_tpu's
    vmap gives each image its own), whose mask is (B, 1, H, W).
    """
    if valid_hw is None:
        return x
    h, w = x.shape[-2:]
    if is_per_image(valid_hw):
        extents = tuple((int(vh), int(vw)) for vh, vw in valid_hw)
        if len(extents) != x.shape[0]:
            raise ValueError(f"{len(extents)} valid extents for a batch of {x.shape[0]}")
        if all(vh >= h and vw >= w for vh, vw in extents):
            return x
        return x * _batch_mask(h, w, extents, x.device, x.dtype)
    vh, vw = int(valid_hw[0]), int(valid_hw[1])
    if vh >= h and vw >= w:
        return x
    rows = torch.arange(h, device=x.device) < vh
    cols = torch.arange(w, device=x.device) < vw
    return x * (rows[:, None] & cols[None, :]).to(x.dtype)


def ceil_div_hw(valid_hw, k: int):
    """Valid extent after a stride-k op with 'same'-style padding
    (conv k3 s2 p1, conv k7 s2 p3, maxpool k3 s2 p1): ceil(v / k), of
    one pair or of each image's."""
    if valid_hw is None:
        return None
    if is_per_image(valid_hw):
        return [ceil_div_hw(hw, k) for hw in valid_hw]
    return ((valid_hw[0] + k - 1) // k, (valid_hw[1] + k - 1) // k)


def floor_div_hw(valid_hw, k: int):
    """Valid extent after max pooling k2 s2 p0 (VGG), which drops a
    trailing odd row: floor(v / k), of one pair or of each image's."""
    if valid_hw is None:
        return None
    if is_per_image(valid_hw):
        return [floor_div_hw(hw, k) for hw in valid_hw]
    return (valid_hw[0] // k, valid_hw[1] // k)


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
