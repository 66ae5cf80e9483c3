"""Device-side image resize for fused TTA (plain PyTorch).

Port of cim_tpu/ops/image.py: resize_bilinear_dynamic (the eval path's)
and resize_bilinear_gather, its gather-form cross-check. cv2.resize
INTER_LINEAR semantics (half-pixel source coordinates
src = (dst + 0.5) * ratio - 0.5, two taps per axis, edge replication), a
per-call scale and source extent, a fixed output canvas, and the
horizontal flip of the hflip TTA passes folded into the source x
coordinate. The taps factor per axis, so the resize is two float32
matrix products, out = Ry @ img @ Rx^T. This is an XLA op in the JAX
package, not a Pallas kernel, so it stays plain PyTorch here.
"""
from __future__ import annotations

import numpy as np
import torch


def _axis_weights(out_len: int, src_static: int, src_valid: float, ratio: float,
                  flip: bool, device) -> torch.Tensor:
    """(out_len, src_static) bilinear weight matrix along one axis."""
    o = torch.arange(out_len, dtype=torch.float32, device=device)
    s = (o + 0.5) * ratio - 0.5
    if flip:
        s = (src_valid - 1.0) - s
    s = s.clamp(0.0, src_valid - 1.0)
    t0 = torch.floor(s)
    frac = s - t0
    t1 = torch.clamp(t0 + 1.0, max=src_valid - 1.0)
    idx = torch.arange(src_static, dtype=torch.float32, device=device)[None, :]
    return (idx == t0[:, None]) * (1.0 - frac)[:, None] + (idx == t1[:, None]) * frac[:, None]


def resize_bilinear_dynamic(image: torch.Tensor, out_hw, scale: float,
                            src_valid_hw, hflip: bool = False):
    """Resize ``image`` (H, W, C) by ``scale`` onto an (out_h, out_w) canvas.

    The content of ``image`` occupies ``src_valid_hw``; the resized content
    fills [0:ovh, 0:ovw] with (ovh, ovw) = round(src_valid * scale) (as
    cv2.resize rounds the output size) and the rest of the canvas is zero.
    Scalars are computed in float32 on the host exactly as the JAX op
    computes them on the device. Returns (out, (ovh, ovw)) with Python ints.
    """
    out_h, out_w = out_hw
    src_h, src_w, (ovh, ovw), ratio_y, ratio_x = _extents(src_valid_hw, scale)
    h, w, _ = image.shape
    dev = image.device
    ry = _axis_weights(out_h, h, src_h, ratio_y, False, dev)
    rx = _axis_weights(out_w, w, src_w, ratio_x, hflip, dev)
    t = torch.einsum("oh,hwc->owc", ry, image.float())
    out = torch.einsum("pw,owc->opc", rx, t)
    out[ovh:] = 0.0
    out[:, ovw:] = 0.0
    return out, (ovh, ovw)


def _extents(src_valid_hw, scale):
    """The float32 host scalars of one image's resize, as
    :func:`resize_bilinear_dynamic` computes them: (src_h, src_w, (ovh,
    ovw), ratio_y, ratio_x)."""
    src_h = np.float32(src_valid_hw[0])
    src_w = np.float32(src_valid_hw[1])
    scale = np.float32(scale)
    ovh = int(np.round(src_h * scale))
    ovw = int(np.round(src_w * scale))
    # cv2 maps dst -> src with the actual ratio src/out, not 1/scale
    ratio_y = float(src_h / np.float32(max(ovh, 1)))
    ratio_x = float(src_w / np.float32(max(ovw, 1)))
    return float(src_h), float(src_w), (ovh, ovw), ratio_y, ratio_x


def resize_bilinear_dynamic_batched(images: torch.Tensor, out_hw, scales,
                                    src_valid_hws, hflip: bool = False):
    """:func:`resize_bilinear_dynamic` of a stack of images, each with its
    own scale and source extent: images (B, H, W, C) -> (B, out_h, out_w,
    C) and the list of each image's (ovh, ovw).

    Each image's two axis matrices are built as the single-image call
    builds them, then stacked and applied with two batched products
    (torch.bmm), which may block their float32 sums otherwise than the
    single-image products do.
    """
    out_h, out_w = out_hw
    b, h, w, c = images.shape
    dev = images.device
    ry, rx, valid = [], [], []
    for scale, src_hw in zip(scales, src_valid_hws, strict=True):
        src_h, src_w, ov, ratio_y, ratio_x = _extents(src_hw, scale)
        ry.append(_axis_weights(out_h, h, src_h, ratio_y, False, dev))
        rx.append(_axis_weights(out_w, w, src_w, ratio_x, hflip, dev))
        valid.append(ov)
    t = torch.bmm(torch.stack(ry), images.float().reshape(b, h, w * c))  # (B, oh, W*C)
    t = t.reshape(b, out_h, w, c).transpose(1, 2).reshape(b, w, out_h * c)
    out = torch.bmm(torch.stack(rx), t)  # (B, ow, oh*C)
    out = out.reshape(b, out_w, out_h, c).transpose(1, 2).contiguous()
    for img, (ovh, ovw) in zip(out, valid):
        img[ovh:] = 0.0
        img[:, ovw:] = 0.0
    return out, valid


def resize_bilinear_gather(image: torch.Tensor, out_hw, scale: float, src_valid_hw,
                           hflip: bool = False):
    """Gather form of :func:`resize_bilinear_dynamic`, the same semantics
    as four full-canvas takes (cim_tpu's cross-check of the matrix form,
    tests/test_image_resize.py). Returns (out, (ovh, ovw))."""
    out_h, out_w = out_hw
    src_h, src_w, (ovh, ovw), ratio_y, ratio_x = _extents(src_valid_hw, scale)
    h, w, c = image.shape
    dev = image.device
    rows = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None].expand(out_h, out_w)
    cols = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :].expand(out_h, out_w)
    sy = (rows + 0.5) * ratio_y - 0.5
    sx = (cols + 0.5) * ratio_x - 0.5
    if hflip:
        sx = (src_w - 1.0) - sx
    sy = sy.clamp(0.0, src_h - 1.0)
    sx = sx.clamp(0.0, src_w - 1.0)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = (sy - y0)[..., None], (sx - x0)[..., None]
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)
    y1i = torch.clamp(y0i + 1, max=int(src_valid_hw[0]) - 1)
    x1i = torch.clamp(x0i + 1, max=int(src_valid_hw[1]) - 1)
    flat = image.float().reshape(h * w, c)

    def take(yy, xx):
        return flat[(yy * w + xx).reshape(-1)].reshape(out_h, out_w, c)

    out = (take(y0i, x0i) * (1 - wy) * (1 - wx) + take(y0i, x1i) * (1 - wy) * wx
           + take(y1i, x0i) * wy * (1 - wx) + take(y1i, x1i) * wy * wx)
    out[ovh:] = 0.0
    out[:, ovw:] = 0.0
    return out, (ovh, ovw)
