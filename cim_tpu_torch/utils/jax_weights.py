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

The bodies: ResNet-50 (inverse of convert_torchvision_resnet50 and the
res1..res4 relabel), dilated VGG-16 (of convert_vgg16; the reference's
``conv{g}.{i}`` names, which cim_tpu reads as ``features.N`` after an
ordered relabel) and HRNet (of convert_hrnet_w48), and cim_tpu's tiny
test body; and the PRM's FCResNet50 (prm_state_dict_from_jax, the inverse
of convert_prm_checkpoint).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from cim_tpu_torch.models.hrnet import W48_STAGES
from cim_tpu_torch.models.vgg import GROUPS as VGG_GROUPS

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
                        refine_times: int = 3, stages=None) -> Dict[str, torch.Tensor]:
    """flax CIMModel variables -> reference-named float32 CPU tensors.
    conv_body: a cfg.MODEL.CONV_BODY name, or its prefix ("resnet50",
    "vgg16", "HRNet", "tiny"). stages: an HRNet body's stage config
    (cfg.MODEL.EXTRA-like; None: W48)."""
    params, stats = variables["params"], variables.get("stats", {})
    sd: Dict[str, torch.Tensor] = {}
    if conv_body.startswith("tiny"):
        _tiny_body(sd, params["conv_body"])
    elif conv_body.startswith("resnet50"):
        _resnet50_body(sd, params["conv_body"], stats["conv_body"])
    elif conv_body.startswith("vgg16"):
        _vgg16_body(sd, params["conv_body"])
    elif conv_body.startswith("HRNet"):
        _hrnet_body(sd, params["conv_body"], stats["conv_body"], stages or W48_STAGES)
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


def _vgg16_body(sd, bp):
    """DilatedVGG16's conv{g}_{j} -> Conv_Body.conv{g}.{2j} (conv, ReLU
    pairs in each group's Sequential)."""
    for g, chans in enumerate(VGG_GROUPS, 1):
        for j in range(len(chans)):
            p = bp[f"conv{g}_{j}"]["conv"]
            sd[f"Conv_Body.conv{g}.{2 * j}.weight"] = _conv(p)
            sd[f"Conv_Body.conv{g}.{2 * j}.bias"] = _tensor(p["bias"])


def _hr_conv_bn(sd, conv, bn, p, s, name):
    """cim_tpu.models.hrnet's {name}_conv / {name}_bn -> conv and bn."""
    c = p[f"{name}_conv"]["conv"]
    sd[conv + ".weight"] = _conv(c)
    if "bias" in c:
        sd[conv + ".bias"] = _tensor(c["bias"])
    _bn(sd, bn, p[f"{name}_bn"], s[f"{name}_bn"])


def _hr_block(sd, pre, p, s):
    """c1/c2[/c3][/ds] -> conv1/bn1 ... [downsample.0/1]."""
    for i in (1, 2, 3):
        if f"c{i}_conv" in p:
            _hr_conv_bn(sd, f"{pre}.conv{i}", f"{pre}.bn{i}", p, s, f"c{i}")
    if "ds_conv" in p:
        _hr_conv_bn(sd, f"{pre}.downsample.0", f"{pre}.downsample.1", p, s, "ds")


def _hrnet_body(sd, bp, bs, stages):
    body = "Conv_Body."
    _hr_conv_bn(sd, body + "conv1", body + "bn1", bp, bs, "stem1")
    _hr_conv_bn(sd, body + "conv2", body + "bn2", bp, bs, "stem2")
    for b in range(stages["STAGE1"]["NUM_BLOCKS"][0]):
        _hr_block(sd, f"{body}layer1.{b}", bp[f"layer1_b{b}"], bs[f"layer1_b{b}"])
    for k in (2, 3, 4):
        sc = stages[f"STAGE{k}"]
        branches = sc["NUM_BRANCHES"]
        trans = f"{body}transition{k - 1}"
        for i in range(branches):
            if f"trans{k}_{i}_conv" in bp:  # a 3x3 conv where the width changes
                _hr_conv_bn(sd, f"{trans}.{i}.0", f"{trans}.{i}.1", bp, bs, f"trans{k}_{i}")
            j = 0
            while f"trans{k}_{i}_{j}_conv" in bp:  # a new branch's stride-2 chain
                _hr_conv_bn(sd, f"{trans}.{i}.{j}.0", f"{trans}.{i}.{j}.1", bp, bs,
                            f"trans{k}_{i}_{j}")
                j += 1
        for m in range(sc["NUM_MODULES"]):
            p, s = bp[f"stage{k}_m{m}"], bs[f"stage{k}_m{m}"]
            pre = f"{body}stage{k}.{m}"
            for i in range(branches):
                for b in range(sc["NUM_BLOCKS"][i]):
                    _hr_block(sd, f"{pre}.branches.{i}.{b}", p[f"branch{i}_block{b}"],
                              s[f"branch{i}_block{b}"])
            for i in range(branches):
                for j in range(i + 1, branches):
                    fuse = f"{pre}.fuse_layers.{i}.{j}"
                    _hr_conv_bn(sd, f"{fuse}.0", f"{fuse}.1", p, s, f"fuse{i}_{j}")
                for j in range(i):
                    for n in range(i - j):
                        fuse = f"{pre}.fuse_layers.{i}.{j}.{n}"
                        _hr_conv_bn(sd, f"{fuse}.0", f"{fuse}.1", p, s, f"fuse{i}_{j}_{n}")
    branches = stages["STAGE4"]["NUM_BRANCHES"]
    for i in range(branches):
        _hr_block(sd, f"{body}incre_modules.{i}.0", bp[f"incre{i}"], bs[f"incre{i}"])
    for i in range(branches - 1):
        _hr_conv_bn(sd, f"{body}downsamp_modules.{i}.0", f"{body}downsamp_modules.{i}.1",
                    bp, bs, f"downsamp{i}")
    _hr_conv_bn(sd, body + "final_layer.0", body + "final_layer.1", bp, bs, "final")


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


_PRM_LAYERS = {"res2": ("features.4", 3), "res3": ("features.5", 4),
               "res4": ("features.6", 6), "res5": ("features.7", 3)}


def prm_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """flax FCResNet50 variables (cim_tpu.prm.model) -> the reference PRM's
    state_dict (features.0 conv1, features.1 bn1, features.4-7 layer1-4,
    classifier.0), which cim_tpu_torch.prm.model.FCResNet50 uses: the
    exact inverse of cim_tpu's convert_prm_checkpoint."""
    params, stats = variables["params"], variables.get("stats", {})
    sd: Dict[str, torch.Tensor] = {"features.0.weight": _conv(params["res1_conv"])}
    _bn(sd, "features.1", params["res1_bn"], stats["res1_bn"])
    for stage, (layer, blocks) in _PRM_LAYERS.items():
        for b in range(blocks):
            p, s = params[f"{stage}_block{b}"], stats[f"{stage}_block{b}"]
            pre = f"{layer}.{b}"
            for i in (1, 2, 3):
                sd[f"{pre}.conv{i}.weight"] = _conv(p[f"conv{i}"])
                _bn(sd, f"{pre}.bn{i}", p[f"bn{i}"], s[f"bn{i}"])
            if b == 0:
                sd[f"{pre}.downsample.0.weight"] = _conv(p["downsample_conv"])
                _bn(sd, f"{pre}.downsample.1", p["downsample_bn"], s["downsample_bn"])
    sd["classifier.0.weight"] = _conv(params["classifier"])
    sd["classifier.0.bias"] = _tensor(params["classifier"]["bias"])
    return sd
