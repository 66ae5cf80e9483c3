"""cim_tpu (flax) variables -> the port's state_dict.

The exact inverse of cim_tpu.utils.torch_weights.convert_reference_checkpoint:
it takes the flax ``{'params', 'stats'}`` tree (numpy or jax arrays, read
through ``np.asarray`` so nothing here imports JAX) and returns a state_dict
under the reference names (``Conv_Body.res1.0.weight``,
``Box_Head.mask_branch.0.weight``, ``cls_iou_model.refine_cls.0.weight``,
...), which CIMModel uses. So one random init drives both packages.

Layouts: conv HWIO -> OIHW; dense (in, out) -> (out, in); FrozenBatchNorm
params (scale, bias) + stats (mean, var) -> weight, bias, running_mean,
running_var.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_STAGES = {"res2": 3, "res3": 4, "res4": 6}


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))  # writable copy


def _conv(p) -> torch.Tensor:
    return _tensor(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))  # HWIO -> OIHW


def _dense(sd, name, p):
    sd[name + ".weight"] = _tensor(np.asarray(p["dense"]["kernel"]).T)
    sd[name + ".bias"] = _tensor(p["dense"]["bias"])


def _bn(sd, name, params, stats):
    sd[name + ".weight"] = _tensor(params["scale"])
    sd[name + ".bias"] = _tensor(params["bias"])
    sd[name + ".running_mean"] = _tensor(stats["mean"])
    sd[name + ".running_var"] = _tensor(stats["var"])


def _tiny_body(sd, bp):
    """cim_tpu.models.tiny's four biased convs -> Conv_Body.conv{i}."""
    for i in range(len(bp)):
        p = bp[f"conv{i}"]["conv"]
        sd[f"Conv_Body.conv{i}.weight"] = _conv(p)
        sd[f"Conv_Body.conv{i}.bias"] = _tensor(p["bias"])


def state_dict_from_jax(variables, conv_body: str = "resnet50",
                        refine_times: int = 3) -> Dict[str, torch.Tensor]:
    """flax CIMModel variables -> reference-named float32 CPU tensors.
    conv_body: a cfg.MODEL.CONV_BODY name, or its prefix ("resnet50",
    "tiny")."""
    params, stats = variables["params"], variables.get("stats", {})
    sd: Dict[str, torch.Tensor] = {}
    if conv_body.startswith("tiny"):
        _tiny_body(sd, params["conv_body"])
    elif conv_body.startswith("resnet50"):
        _resnet50_body(sd, params["conv_body"], stats["conv_body"])
    else:
        raise NotImplementedError(f"conv body {conv_body!r} is not ported yet")
    _heads(sd, params, refine_times)
    return sd


def _resnet50_body(sd, bp, bs):
    sd["Conv_Body.res1.0.weight"] = _conv(bp["res1_conv"]["conv"])
    _bn(sd, "Conv_Body.res1.1", bp["res1_bn"], bs["res1_bn"])
    for stage, blocks in _STAGES.items():
        for b in range(blocks):
            p, s = bp[stage][f"block{b}"], bs[stage][f"block{b}"]
            pre = f"Conv_Body.{stage}.{b}"
            for i in (1, 2, 3):
                sd[f"{pre}.conv{i}.weight"] = _conv(p[f"conv{i}"]["conv"])
                _bn(sd, f"{pre}.bn{i}", p[f"bn{i}"], s[f"bn{i}"])
            if b == 0:
                sd[f"{pre}.downsample.0.weight"] = _conv(p["downsample_conv"]["conv"])
                _bn(sd, f"{pre}.downsample.1", p["downsample_bn"], s["downsample_bn"])


def _heads(sd, params, refine_times):
    hp = params["box_head"]
    sd["Box_Head.mask_branch.0.weight"] = _conv(hp["mask_branch"]["conv"])
    sd["Box_Head.mask_branch.0.bias"] = _tensor(hp["mask_branch"]["conv"]["bias"])
    _dense(sd, "Box_Head.seg_fc.0", hp["seg_fc1"])
    _dense(sd, "Box_Head.seg_fc.2", hp["seg_fc2"])

    cp = params["cls_iou"]
    for name in ("classifier", "detector"):
        _dense(sd, f"cls_iou_model.{name}", cp[name])
    for k in range(refine_times):
        _dense(sd, f"cls_iou_model.refine_cls.{k}", cp[f"refine_cls{k}"])
        _dense(sd, f"cls_iou_model.refine_iou.{k}", cp[f"refine_iou{k}"])
