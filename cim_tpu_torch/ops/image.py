"""Device-side image resize for fused TTA (plain PyTorch).

Port of cim_tpu/ops/image.py:resize_bilinear_dynamic: cv2.resize
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
    src_h = np.float32(src_valid_hw[0])
    src_w = np.float32(src_valid_hw[1])
    scale = np.float32(scale)
    ovh = int(np.round(src_h * scale))
    ovw = int(np.round(src_w * scale))
    # cv2 maps dst -> src with the actual ratio src/out, not 1/scale
    ratio_y = float(src_h / np.float32(max(ovh, 1)))
    ratio_x = float(src_w / np.float32(max(ovw, 1)))

    h, w, _ = image.shape
    dev = image.device
    ry = _axis_weights(out_h, h, float(src_h), ratio_y, False, dev)
    rx = _axis_weights(out_w, w, float(src_w), ratio_x, hflip, dev)
    t = torch.einsum("oh,hwc->owc", ry, image.float())
    out = torch.einsum("pw,owc->opc", rx, t)
    out[ovh:] = 0.0
    out[:, ovw:] = 0.0
    return out, (ovh, ovw)
