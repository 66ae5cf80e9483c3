"""CIM's network in plain PyTorch: a conv body, MaskFuse and the cls/iou
heads, at the image's and the proposals' true sizes (no padding).

Module and parameter names are the reference checkpoint's (``Conv_Body``,
``Box_Head``, ``cls_iou_model``), so one state_dict loads into this model
and into the program's.

Precision: "f32" computes everything in float32 (TF32 off is the caller's
business: see ``no_tf32``). "bf16" computes the body and MaskFuse as the
configuration states (bf16_compute: bfloat16 activations, float32
parameters cast at each layer, RoIAlign summed in float32 and rounded to
bfloat16) and the heads in float32. "fp8" is the control, one step below
the configuration: "bf16" with the operands of every convolution and
linear layer of the body and MaskFuse rounded to float8 e4m3 under a
per-tensor scale, as an fp8 GEMM takes them; gradients pass the rounding
unchanged.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.bodies import conv_body
from benchmark.reference.roi_align import roi_align

FP8_MAX = 448.0  # largest finite float8 e4m3fn


@contextlib.contextmanager
def no_tf32():
    """Float32 products and convolutions for the block (TF32 off in cuBLAS
    and cuDNN); the flags are restored after it."""
    flags = torch.backends.cudnn, torch.backends.cuda.matmul
    before = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, b in zip(flags, before):
            f.allow_tf32 = b


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale (amax -> 448),
    back in t's dtype; the gradient passes unchanged."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach()


class Conv2d(nn.Conv2d):
    """Computes in its input's dtype; with ``fp8`` its operands rounded."""

    fp8 = False

    def forward(self, x):
        w = fp8_round(self.weight) if self.fp8 else self.weight
        x = fp8_round(x) if self.fp8 else x
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, w.to(x.dtype), b)


class Linear(nn.Linear):
    """Computes in its input's dtype; with ``fp8`` its operands rounded."""

    fp8 = False

    def forward(self, x):
        w = fp8_round(self.weight) if self.fp8 else self.weight
        x = fp8_round(x) if self.fp8 else x
        return F.linear(x, w.to(x.dtype), self.bias.to(x.dtype))


class FrozenBatchNorm(nn.Module):
    """y = weight * (x - mean) / sqrt(var + eps) + bias, statistics frozen."""

    def __init__(self, n: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        off = self.bias - self.running_mean * inv
        return x * inv.to(x.dtype).view(1, -1, 1, 1) + off.to(x.dtype).view(1, -1, 1, 1)


# ------------------------------------------- the bodies' shared block

class Bottleneck(nn.Module):
    """torchvision v1.5 bottleneck: 1x1 -> 3x3 (stride) -> 1x1, x4 width."""

    def __init__(self, inplanes, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = nn.Sequential(
            Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
            FrozenBatchNorm(planes * 4)) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


# ------------------------------------------------------------ head, model

class MaskFuse(nn.Module):
    """RoIAlign -> gate by the 7x7 proposal mask -> 3x3 conv 2C -> C ->
    FC C*49 -> hidden -> hidden, ReLU after each."""

    def __init__(self, dim_in, spatial_scale, hidden=4096, roi=7, cap=4, dtype=torch.float32):
        super().__init__()
        self.spatial_scale, self.roi, self.cap, self.dtype = spatial_scale, roi, cap, dtype
        self.mask_branch = nn.Sequential(Conv2d(dim_in * 2, dim_in, 3, padding=1), nn.ReLU())
        self.seg_fc = nn.Sequential(Linear(dim_in * roi * roi, hidden), nn.ReLU(),
                                    Linear(hidden, hidden), nn.ReLU())

    def forward(self, feat, rois, masks):
        """feat (h, w, C), rois (N, 4), masks (N, 7, 7) -> (N, hidden)."""
        feat = feat.to(self.dtype)
        box_x = roi_align(feat, rois, self.roi, self.spatial_scale, 0, self.cap).to(self.dtype)
        mask_x = box_x * masks.to(self.dtype)[..., None]
        x = torch.cat([box_x, mask_x], dim=-1).permute(0, 3, 1, 2)
        x = self.mask_branch(x)
        return self.seg_fc(x.reshape(x.shape[0], -1)).float()


class ClsIouHead(nn.Module):
    def __init__(self, dim_in, num_classes, refine_times):
        super().__init__()
        out = num_classes + 1
        self.classifier = Linear(dim_in, out)
        self.detector = Linear(dim_in, out)
        self.refine_cls = nn.ModuleList(Linear(dim_in, out) for _ in range(refine_times))
        self.refine_iou = nn.ModuleList(Linear(dim_in, out) for _ in range(refine_times))

    def forward(self, x):
        """x (N, D) -> predict_cls, predict_det (N, C+1), refine_cls and
        refine_iou (K, N, C+1); the detector's softmax runs over the N
        proposals."""
        return (torch.softmax(self.classifier(x), dim=-1),
                torch.softmax(self.detector(x), dim=0),
                torch.stack([torch.softmax(m(x), dim=-1) for m in self.refine_cls]),
                torch.stack([torch.sigmoid(m(x)) for m in self.refine_iou]))


class CIMModel(nn.Module):
    def __init__(self, body: str, num_classes=20, refine_times=3, hidden=4096,
                 cap=4, prec="f32"):
        super().__init__()
        if prec not in ("f32", "bf16", "fp8"):
            raise ValueError(f"precision {prec!r}: f32, bf16 or fp8")
        self.dtype = torch.float32 if prec == "f32" else torch.bfloat16
        cls = conv_body(body).Body
        self.Conv_Body = cls()
        self.Box_Head = MaskFuse(cls.dim_out, 1.0 / cls.stride, hidden, 7, cap, self.dtype)
        self.cls_iou_model = ClsIouHead(hidden, num_classes, refine_times)
        if prec == "fp8":
            for part in (self.Conv_Body, self.Box_Head):
                for m in part.modules():
                    if isinstance(m, (Conv2d, Linear)):
                        m.fp8 = True

    def forward(self, image, rois, masks):
        """image (h, w, 3) float32 at its true size, rois (N, 4) in its
        coordinates, masks (N, 7, 7) -> dict of the heads' outputs."""
        x = image.permute(2, 0, 1)[None].to(self.dtype)
        feat = self.Conv_Body(x)[0].permute(1, 2, 0).float()
        p_cls, p_det, r_cls, r_iou = self.cls_iou_model(self.Box_Head(feat, rois, masks))
        return {"predict_cls": p_cls, "predict_det": p_det,
                "refine_cls": r_cls, "refine_iou": r_iou}

    def freeze(self, freeze_at: int):
        """requires_grad False on the body's first ``freeze_at`` stages."""
        frozen = [f"Conv_Body.{p}" for p in self.Conv_Body.frozen(freeze_at)]
        for name, p in self.named_parameters():
            p.requires_grad_(not any(name == f or name.startswith(f + ".") for f in frozen))
        return self
