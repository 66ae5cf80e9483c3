"""Seeded weights of a configuration, made on the device in one draw.

Conv and linear weights and biases are PyTorch's default init, uniform in
+-1/sqrt(fan_in); the frozen BatchNorm layers get random statistics and
affine terms (mean and bias in +-0.1, variance and scale in 0.5-1.5), so
that no layer is the identity. The same seed gives the same state_dict,
which the harness loads into the program and into the reference.
"""
from __future__ import annotations

import math

import torch

from benchmark.generate import sub_seed
from benchmark.reference.model import CIMModel


def meta_model(model: dict) -> CIMModel:
    with torch.device("meta"):
        return CIMModel(model["body"], model["classes"], model["refine"], model["hidden"],
                        model["cap"])


def _ranges(name: str, shape, fan_in: dict):
    """(lo, hi) of the uniform draw of one state_dict entry."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "running_mean":
        return -0.1, 0.1
    if leaf == "running_var":
        return 0.5, 1.5
    owner = name.rsplit(".", 1)[0]
    if owner in fan_in:
        b = 1.0 / math.sqrt(fan_in[owner])
        return -b, b
    # a frozen BatchNorm's affine terms
    return (0.5, 1.5) if leaf == "weight" else (-0.1, 0.1)


def make_state_dict(model: dict, seed: int, device) -> dict:
    """{name: float32 tensor on ``device``} for every parameter and buffer
    of the configuration's network, views of one seeded draw."""
    net = meta_model(model)
    fan_in = {n: m.weight[0].numel() for n, m in net.named_modules()
              if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))}
    shapes = [(n, t.shape) for n, t in net.state_dict().items()]
    total = sum(math.prod(s) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        lo, hi = _ranges(name, shape, fan_in)
        out[name] = flat[at:at + n].view(shape).mul_(hi - lo).add_(lo)
        at += n
    return out
