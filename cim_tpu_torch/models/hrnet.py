"""HRNet-W48 backbone, HRNetV2 classification trunk (port of
cim_tpu/models/hrnet.py).

Stem (two stride-2 3x3 convs) -> layer1 (bottlenecks, 256 channels) ->
stages 2-4 of parallel branches with transitions and a SUM fuse ->
the classification head (per-branch bottleneck ``incre`` modules, a
strided ``downsamp`` chain, a 1x1 ``final`` layer): 2048 channels at
stride 32. Every BatchNorm is frozen.

The input image's pad is re-zeroed once and the input padded to multiples
of 32; the pad then runs through the convs and BNs unmasked, as in
cim_tpu and in the reference's own pad-to-32 run, so RoIAlign reads the
whole feature map (feature_valid_hw is None).

Module names are the reference HRNet's (``conv1``/``bn1``,
``layer1.{b}``, ``transition{k}.{i}[.{j}]``, ``stage{k}.{m}.branches``,
``stage{k}.{m}.fuse_layers``, ``incre_modules``, ``downsamp_modules``,
``final_layer``), which cim_tpu's convert_hrnet_w48 reads.
"""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from cim_tpu_torch.models.layers import Conv2d, FrozenBatchNorm, mask_valid_hw
from cim_tpu_torch.models.resnet import Bottleneck

# cfg.MODEL.EXTRA of the W48 trunk (configs/hrnet48_voc.yaml, without FUSE_METHOD)
W48_STAGES = {
    "STAGE1": {"NUM_MODULES": 1, "NUM_BRANCHES": 1, "BLOCK": "BOTTLENECK",
               "NUM_BLOCKS": [4], "NUM_CHANNELS": [64]},
    "STAGE2": {"NUM_MODULES": 1, "NUM_BRANCHES": 2, "BLOCK": "BASIC",
               "NUM_BLOCKS": [4, 4], "NUM_CHANNELS": [48, 96]},
    "STAGE3": {"NUM_MODULES": 4, "NUM_BRANCHES": 3, "BLOCK": "BASIC",
               "NUM_BLOCKS": [4, 4, 4], "NUM_CHANNELS": [48, 96, 192]},
    "STAGE4": {"NUM_MODULES": 3, "NUM_BRANCHES": 4, "BLOCK": "BASIC",
               "NUM_BLOCKS": [4, 4, 4, 4], "NUM_CHANNELS": [48, 96, 192, 384]},
}
HEAD_CHANNELS = (32, 64, 128, 256)  # the incre bottlenecks' widths (x4 out)


def _conv_bn(cin, cout, kernel, stride, device, relu=True, bias=False):
    """[conv, BN(, ReLU)]: the reference's Sequential of a conv and its BN."""
    layers = [Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=bias,
                     device=device),
              FrozenBatchNorm(cout, device=device)]
    return layers + [nn.ReLU()] if relu else layers


class BasicBlock(nn.Module):
    """Two 3x3 convs with BN and a residual."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, device=None):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False,
                            device=device)
        self.bn1 = FrozenBatchNorm(planes, device=device)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False, device=device)
        self.bn2 = FrozenBatchNorm(planes, device=device)
        self.downsample = (nn.Sequential(*_conv_bn(inplanes, planes, 1, stride, device,
                                                   relu=False))
                           if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


# the bottleneck is ResNet's (1x1, 3x3 with the stride, 1x1 x4), unmasked
_BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}


class HRModule(nn.Module):
    """One high-resolution module: parallel branches, then each output the
    ReLU of the SUM over branches j of branch j brought to branch i's
    resolution (1x1 conv, BN and nearest upsampling by 2^(j-i) for j > i;
    a chain of stride-2 3x3 conv + BN, ReLU between links, for j < i)."""

    def __init__(self, num_branches, block, num_blocks, num_inchannels, num_channels,
                 device=None):
        super().__init__()
        blk = _BLOCKS[block]
        chans = [c * blk.expansion for c in num_channels]
        self.branches = nn.ModuleList()
        for i in range(num_branches):
            layers = [blk(num_inchannels[i], num_channels[i],
                          downsample=num_inchannels[i] != chans[i], device=device)]
            layers += [blk(chans[i], num_channels[i], device=device)
                       for _ in range(1, num_blocks[i])]
            self.branches.append(nn.Sequential(*layers))
        self.fuse_layers = None
        if num_branches == 1:
            return
        self.fuse_layers = nn.ModuleList()
        for i in range(num_branches):
            row = []
            for j in range(num_branches):
                if j > i:
                    # nearest upsampling keeps channels_last (a repeat would not)
                    row.append(nn.Sequential(
                        *_conv_bn(chans[j], chans[i], 1, 1, device, relu=False),
                        nn.Upsample(scale_factor=2 ** (j - i), mode="nearest")))
                elif j == i:
                    row.append(None)
                else:
                    row.append(nn.Sequential(*(
                        nn.Sequential(*_conv_bn(chans[j], chans[i] if k == i - j - 1 else chans[j],
                                                3, 2, device, relu=k != i - j - 1))
                        for k in range(i - j))))
            self.fuse_layers.append(nn.ModuleList(row))

    def forward(self, xs):
        xs = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return xs
        fused = []
        for row in self.fuse_layers:
            y = None
            for x, layer in zip(xs, row):
                t = x if layer is None else layer(x)
                y = t if y is None else y + t
            fused.append(F.relu(y))
        return fused


def _transition(pre_chans, cur_chans, device):
    """The reference's transition into a stage: branch i keeps its input
    (None), or takes a 3x3 conv where its width changes; a new branch is
    a chain of stride-2 3x3 convs from the last branch."""
    layers = []
    for i, cur in enumerate(cur_chans):
        if i < len(pre_chans):
            layers.append(None if cur == pre_chans[i]
                          else nn.Sequential(*_conv_bn(pre_chans[i], cur, 3, 1, device)))
        else:
            n = i + 1 - len(pre_chans)
            layers.append(nn.Sequential(*(
                nn.Sequential(*_conv_bn(pre_chans[-1], cur if j == n - 1 else pre_chans[-1],
                                        3, 2, device))
                for j in range(n))))
    return nn.ModuleList(layers)


class HRNetW48(nn.Module):
    """The HRNetV2 classification trunk: 2048 channels at stride 32.
    ``stages``: a cfg.MODEL.EXTRA-like dict; None takes the class's STAGES
    (W48). The head's widths are fixed, whatever the stages."""

    dim_out = 2048
    spatial_scale = 1.0 / 32.0
    STAGES = W48_STAGES

    def __init__(self, stages=None, device=None):
        super().__init__()
        cfg = stages or self.STAGES
        self.conv1, self.bn1 = _conv_bn(3, 64, 3, 2, device, relu=False)
        self.conv2, self.bn2 = _conv_bn(64, 64, 3, 2, device, relu=False)
        s1 = cfg["STAGE1"]
        blk = _BLOCKS[s1["BLOCK"]]
        ch1 = s1["NUM_CHANNELS"][0]
        self.layer1 = nn.Sequential(
            blk(64, ch1, downsample=True, device=device),
            *(blk(ch1 * blk.expansion, ch1, device=device)
              for _ in range(1, s1["NUM_BLOCKS"][0])))
        pre_chans = [ch1 * blk.expansion]
        for k in (2, 3, 4):
            sc = cfg[f"STAGE{k}"]
            cur_chans = [c * _BLOCKS[sc["BLOCK"]].expansion for c in sc["NUM_CHANNELS"]]
            self.add_module(f"transition{k - 1}", _transition(pre_chans, cur_chans, device))
            self.add_module(f"stage{k}", nn.ModuleList(
                HRModule(sc["NUM_BRANCHES"], sc["BLOCK"], sc["NUM_BLOCKS"], cur_chans,
                         sc["NUM_CHANNELS"], device=device)
                for _ in range(sc["NUM_MODULES"])))
            pre_chans = cur_chans
        head = [c * Bottleneck.expansion for c in HEAD_CHANNELS]
        self.incre_modules = nn.ModuleList(
            nn.Sequential(Bottleneck(c, h, downsample=True, device=device))
            for c, h in zip(pre_chans, HEAD_CHANNELS))
        self.downsamp_modules = nn.ModuleList(
            nn.Sequential(*_conv_bn(head[i], head[i + 1], 3, 2, device, bias=True))
            for i in range(len(pre_chans) - 1))
        self.final_layer = nn.Sequential(*_conv_bn(head[-1], self.dim_out, 1, 1, device,
                                                   bias=True))

    def forward(self, x, valid_hw=None):
        """x: (B, 3, H, W); valid_hw: optional (h, w) image extent inside a
        zero-padded bucket, or one such pair per image: only the image's
        pad is re-zeroed, then the input is padded to multiples of 32."""
        x = mask_valid_hw(x, valid_hw)
        hp, wp = -x.shape[-2] % 32, -x.shape[-1] % 32
        if hp or wp:
            x = F.pad(x, (0, wp, 0, hp))  # keeps the memory format
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for k in (2, 3, 4):
            trans = getattr(self, f"transition{k - 1}")
            xs = [xs[i] if layer is None else layer(xs[min(i, len(xs) - 1)])
                  for i, layer in enumerate(trans)]
            for module in getattr(self, f"stage{k}"):
                xs = module(xs)
        y = self.incre_modules[0](xs[0])
        for i, down in enumerate(self.downsamp_modules):
            y = self.incre_modules[i + 1](xs[i + 1]) + down(y)
        return self.final_layer(y)

    @staticmethod
    def feature_valid_hw(im_hw):
        """None: RoIAlign reads the whole map, pad included."""
        return None


def frozen_param_paths(freeze_at: int):
    """Module paths under the body that HRNET.FREEZE_AT freezes, as
    cim_tpu's frozen_param_paths does: 1 the stem and layer1, k > 1 the
    modules of stage k (not the transition into it)."""
    out = []
    for i in range(1, freeze_at + 1):
        out += ["conv1", "bn1", "conv2", "bn2", "layer1"] if i == 1 else [f"stage{i}"]
    return out
