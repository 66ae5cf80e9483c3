"""Peak Response Mapping model: FC-ResNet50, peak finding and peak
backpropagation (port of cim_tpu/prm/model.py).

- FCResNet50 (reference lib/prm/prm_model.py:279-307): the ResNet-50
  trunk (conv1..layer4, stride 32) and a 1x1 conv classifier give class
  response maps, under the reference's module names (features.0 conv1,
  features.1 bn1, features.4-7 layer1-4, classifier.0), so a reference PRM
  checkpoint loads with load_prm_checkpoint;
- PeakResponseMapper.inference_gt (reference prm_model_gt.py:216-290):
  CRMs upsampled x8 (bilinear, align_corners), peaks of the ground-truth
  classes above a threshold with a best-peak fallback, and one input
  gradient under the pr_conv excitation rule for each peak.

cim_tpu backpropagates all peaks of an image with one jax.vjp vmapped over
one-hot cotangents. Here the forward runs on a batch of K copies of the
image (K the number of peaks, at most MAX_PEAKS, all in one pass) and one
backward takes one peak per copy: the layers are independent across the
batch (frozen BN) and min(x) over identical copies is one copy's, so each
copy's input gradient is its peak's response map.

The convolutions run in float32, TF32 off, whatever the process's flags.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from cim_tpu_torch.models.layers import FrozenBatchNorm
from cim_tpu_torch.prm.modules import find_peaks, pr_conv
from cim_tpu_torch.utils.device import no_tf32, resolve_device

MAX_PEAKS = 64


class PRConv2d(nn.Conv2d):
    """Conv whose backward is the excitation rule (pr_conv) when
    ``excitation`` is set, the ordinary one otherwise."""

    def __init__(self, *args, excitation: bool = True, **kw):
        super().__init__(*args, **kw)
        self.excitation = excitation

    def forward(self, x):
        if self.excitation:
            return pr_conv(x, self.weight, self.bias, self.stride, self.padding, self.dilation)
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding, self.dilation)


class PRBottleneck(nn.Module):
    """torchvision's Bottleneck (stride on the 3x3 conv) with frozen BN."""

    def __init__(self, inplanes, planes, stride=1, downsample=False, excitation=True):
        super().__init__()
        e = excitation
        self.conv1 = PRConv2d(inplanes, planes, 1, bias=False, excitation=e)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = PRConv2d(planes, planes, 3, stride=stride, padding=1, bias=False,
                              excitation=e)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = PRConv2d(planes, planes * 4, 1, bias=False, excitation=e)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = nn.Sequential(
            PRConv2d(inplanes, planes * 4, 1, stride=stride, bias=False, excitation=e),
            FrozenBatchNorm(planes * 4),
        ) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        sc = x if self.downsample is None else self.downsample(x)
        return F.relu(out + sc)


class FCResNet50(nn.Module):
    """ResNet-50 trunk + 1x1 classifier: (B, 3, H, W) -> (B, C, H/32, W/32)
    class response maps. excitation: the pr_conv backward (peak backprop);
    training uses the ordinary one."""

    def __init__(self, num_classes: int = 20, excitation: bool = True):
        super().__init__()
        e = excitation
        layers = []
        inplanes = 64
        for planes, blocks, stride in ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)):
            stage = [PRBottleneck(inplanes, planes, stride, downsample=True, excitation=e)]
            stage += [PRBottleneck(planes * 4, planes, excitation=e) for _ in range(1, blocks)]
            layers.append(nn.Sequential(*stage))
            inplanes = planes * 4
        self.features = nn.Sequential(
            PRConv2d(3, 64, 7, stride=2, padding=3, bias=False, excitation=e),
            FrozenBatchNorm(64),
            nn.ReLU(),
            nn.MaxPool2d(3, 2, 1),
            *layers,
        )
        self.classifier = nn.Sequential(PRConv2d(2048, num_classes, 1, excitation=e))

    def forward(self, x):
        return self.classifier(self.features(x))


def prm_state_dict(sd) -> dict:
    """A reference PRM checkpoint's state_dict under this model's names:
    without DataParallel's ``module.`` prefix and BN's num_batches_tracked."""
    return {k.replace("module.", "", 1) if k.startswith("module.") else k: v
            for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def load_prm_checkpoint(model: FCResNet50, path_or_sd):
    """Load a reference-named PRM checkpoint (a path or a state_dict; a
    dict holding it under 'model' or 'state_dict' too), strictly."""
    sd = path_or_sd
    if not isinstance(sd, dict):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    sd = sd.get("model", sd.get("state_dict", sd))
    model.load_state_dict(prm_state_dict(sd), strict=True)
    return model


class PeakOutputs(NamedTuple):
    aggregation: np.ndarray  # (C,) peak-aggregated class scores
    crm: np.ndarray  # (C, Hs, Ws) upsampled class response maps
    peaks: np.ndarray  # (MAX_PEAKS, 3) [y, x, class], valid-prefixed
    peak_scores: np.ndarray  # (MAX_PEAKS,)
    peak_response_maps: np.ndarray  # (MAX_PEAKS, H_in, W_in)
    num_peaks: int


def _align_corners_taps(n: int, factor: int):
    """cim_tpu's _upsample_align_corners taps along one axis in float32,
    as jnp.linspace(0, n - 1, n * factor) computes them: (i0, i1, weight)."""
    m = n * factor
    step = np.arange(m - 1, dtype=np.float32) / np.float32(m - 1)
    pos = np.concatenate([np.float32(n - 1) * step, [np.float32(n - 1)]]).astype(np.float32)
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, n - 1)
    i1 = np.clip(i0 + 1, 0, n - 1)
    return i0, i1, (pos - i0).astype(np.float32)


def upsample_align_corners(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Bilinear x factor with align_corners=True (torch F.upsample as at
    prm_model_gt.py:227-229), as cim_tpu's gather arithmetic: (B, C, h, w)
    -> (B, C, h * factor, w * factor)."""
    h, w = x.shape[-2:]
    dev = x.device
    y0, y1, wy = (torch.from_numpy(a).to(dev) for a in _align_corners_taps(h, factor))
    x0, x1, wx = (torch.from_numpy(a).to(dev) for a in _align_corners_taps(w, factor))
    wy, wx = wy[:, None], wx[None, :]
    rows0, rows1 = x[:, :, y0], x[:, :, y1]
    a, bq = rows0[..., x0], rows0[..., x1]
    cq, d = rows1[..., x0], rows1[..., x1]
    return (a * (1 - wy) * (1 - wx) + bq * (1 - wy) * wx
            + cq * wy * (1 - wx) + d * wy * wx)


class PeakResponseMapper:
    """Runs the PRM as the reference's model.inference() mode: the model is
    FCResNet50 with the excitation backward, on ``device``, its parameters
    frozen (peak backprop takes gradients of the input only)."""

    def __init__(self, num_classes=20, sub_pixel_locating_factor=8, win_size=3,
                 peak_threshold=10.0, device="cuda"):
        self.num_classes = num_classes
        self.factor = sub_pixel_locating_factor
        self.win_size = win_size
        self.peak_threshold = peak_threshold
        self.device = resolve_device(device)
        self.model = FCResNet50(num_classes, excitation=True).to(self.device)
        self.model.eval().requires_grad_(False)

    def _image(self, image) -> torch.Tensor:
        """(H, W, 3) float32 array -> (1, 3, H, W) on the device."""
        x = torch.as_tensor(np.ascontiguousarray(image, np.float32))
        return x.permute(2, 0, 1)[None].to(self.device)

    def crm(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> (B, C, Hs, Ws) upsampled class response maps."""
        return upsample_align_corners(self.model(x), self.factor)

    @torch.no_grad()
    def crm_and_peaks(self, image):
        """(crm (C, Hs, Ws), peak map (C, Hs, Ws) bool) of an (H, W, 3) image,
        on the device."""
        with no_tf32():
            crm = self.crm(self._image(image))
        return crm[0], find_peaks(crm, self.win_size, True)[0]

    def peak_response_maps(self, image, peaks) -> torch.Tensor:
        """(K, H, W) maps on the device, one per peak (y, x, class) of the
        upsampled CRM: the input gradient of that CRM value under the
        excitation rule, summed over RGB, clipped at 0, normalized to sum 1.
        The K copies of the image go through one forward and one backward
        (inference_gt passes K <= MAX_PEAKS)."""
        p = torch.as_tensor(np.asarray(peaks, np.int64).reshape(-1, 3), device=self.device)
        copies = self._image(image).expand(len(p), -1, -1, -1).clone().requires_grad_(True)
        with torch.enable_grad(), no_tf32():
            crm = self.crm(copies)
            picked = crm[torch.arange(len(p), device=self.device), p[:, 2], p[:, 0], p[:, 1]]
            (g,) = torch.autograd.grad(picked.sum(), copies)
        g = g.sum(dim=1).clamp(min=0.0)
        total = g.sum(dim=(1, 2), keepdim=True)
        return g / torch.maximum(total, torch.full_like(total, 1e-12))

    def select_peaks(self, crm: np.ndarray, peak_map: np.ndarray, gt_classes):
        """[(y, x, class, score)] as the reference selects them: per gt class
        in the order given, its row-major peaks above peak_threshold, or its
        best peak if none is; at most MAX_PEAKS."""
        sel = []
        for cls in gt_classes:
            ys, xs = np.nonzero(peak_map[cls])
            if len(ys) == 0:
                continue
            vals = crm[cls, ys, xs]
            above = vals > self.peak_threshold
            if above.any():
                sel.extend(zip(ys[above], xs[above], [cls] * int(above.sum()), vals[above]))
            else:  # best-peak fallback
                j = int(np.argmax(vals))
                sel.append((ys[j], xs[j], cls, vals[j]))
        return sel[:MAX_PEAKS]

    def inference_gt(self, image, gt_classes) -> PeakOutputs:
        """Peaks of the gt classes of an (H, W, 3) normalized image and their
        response maps (reference prm_model_gt forward :216-290)."""
        crm_t, pm_t = self.crm_and_peaks(image)
        crm, pm = crm_t.cpu().numpy(), pm_t.cpu().numpy()
        sel = self.select_peaks(crm, pm, gt_classes)
        n = len(sel)
        h, w = np.shape(image)[:2]
        prms = np.zeros((MAX_PEAKS, h, w), np.float32)
        peaks = np.zeros((MAX_PEAKS, 3), np.int32)
        scores = np.zeros((MAX_PEAKS,), np.float32)
        for i, (y, x, cls, v) in enumerate(sel):
            peaks[i] = (y, x, cls)
            scores[i] = v
        if n:
            prms[:n] = self.peak_response_maps(image, peaks[:n]).cpu().numpy()
        agg = np.zeros(self.num_classes, np.float32)
        for cls in range(self.num_classes):
            m = pm[cls]
            if m.any():
                agg[cls] = crm[cls][m].mean()
        return PeakOutputs(agg, crm, peaks, scores, prms, n)
