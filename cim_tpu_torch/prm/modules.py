"""Peak Response Mapping primitives (port of cim_tpu/prm/modules.py;
reference lib/prm/prm_modules.py).

- find_peaks: a position is a peak iff it is the last (row-major)
  maximum of its window, with -inf outside the map (cim_tpu's rule; the
  reference takes the first, which differs on ties only), and (with the
  median filter) at least its map's median;
- peak_stimulation (:9-55): the peak map and the mean of the CRM over the
  peaks of each class, whose backward routes the gradient to the peaks;
- pr_conv (pr_conv2d and its hooks, :104-140) and eb_linear: layers whose
  backward is the excitation rule of peak backpropagation.

Layout is PyTorch's NCHW (cim_tpu's is NHWC). Each custom VJP of cim_tpu
is a torch.autograd.Function here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-10


def median_peak_filter(x: torch.Tensor) -> torch.Tensor:
    """Per-(batch, class) median of the map, (B, C, 1, 1), as jnp.median
    computes it: for an even count the mean of the two middle values
    ((lo + hi) * 0.5), where torch.median takes the lower one."""
    b, c, h, w = x.shape
    n = h * w
    s = x.reshape(b, c, n).sort(dim=-1).values
    lo, hi = (n - 1) // 2, n // 2
    return ((s[..., lo] + s[..., hi]) * 0.5).reshape(b, c, 1, 1)


def find_peaks(crm: torch.Tensor, win_size: int = 3, use_median_filter: bool = True):
    """Peak mask (B, C, H, W) bool of class response maps (B, C, H, W).

    cim_tpu's rule, with -inf outside the map: a position is a peak iff it
    is >= every element of its window before it (row-major) and strictly
    greater than every element after it, i.e. the last row-major maximum of
    its window. The reference's max_pool2d(return_indices) == element test
    takes the first instead; the two differ only on ties (a plateau gives
    one peak under each, at its other end). x == max_pool2d(x) would mark
    whole plateaus.
    """
    if win_size % 2 != 1:
        raise ValueError(f"win_size must be odd, not {win_size}")
    pad = (win_size - 1) // 2
    h, w = crm.shape[-2:]
    padded = F.pad(crm, (pad, pad, pad, pad), value=float("-inf"))
    before = torch.full_like(crm, float("-inf"))
    after = torch.full_like(crm, float("-inf"))
    for dy in range(-pad, pad + 1):
        for dx in range(-pad, pad + 1):
            if dy == 0 and dx == 0:
                continue
            nb = padded[..., pad + dy:pad + dy + h, pad + dx:pad + dx + w]  # crm[y + dy, x + dx]
            if dy < 0 or (dy == 0 and dx < 0):
                before = torch.maximum(before, nb)
            else:
                after = torch.maximum(after, nb)
    peak_map = (crm >= before) & (crm > after)
    if use_median_filter:
        peak_map = peak_map & (crm >= median_peak_filter(crm))
    return peak_map


class _PeakStimulation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, crm, win_size, use_median_filter):
        peak_map = find_peaks(crm, win_size, use_median_filter)
        pm = peak_map.to(crm.dtype)
        count = pm.sum(dim=(2, 3))
        agg = (crm * pm).sum(dim=(2, 3)) / torch.maximum(count, torch.full_like(count, 1e-12))
        ctx.save_for_backward(pm)
        ctx.mark_non_differentiable(peak_map)
        return peak_map, agg

    @staticmethod
    def backward(ctx, _g_peak_map, g_agg):
        (pm,) = ctx.saved_tensors
        return pm * g_agg[:, :, None, None], None, None


def peak_stimulation(crm: torch.Tensor, win_size: int = 3, use_median_filter: bool = True):
    """(peak_map (B, C, H, W) bool, aggregation (B, C)): the mean CRM over
    each class's peaks. Backward (reference PeakStimulation.backward
    :46-51): the aggregation's gradient broadcast onto the peaks, with no
    1/num_peaks factor (deliberately not the mean's true gradient)."""
    return _PeakStimulation.apply(crm, win_size, use_median_filter)


def _excitation_grad(shifted, norm, g, input_grad):
    """The excitation rule's input gradient: g normalized by |norm| (0
    where norm < eps), sent back through the positive weights
    (input_grad), times the shifted input."""
    g_norm = torch.where(norm < EPS, torch.zeros_like(g), g / (norm.abs() + EPS))
    return shifted * input_grad(g_norm)


class _PRConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation)
        return F.conv2d(x, w, b, stride, padding, dilation)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation = ctx.conf
        shifted = x - x.min()
        pos_w = F.relu(w)
        norm = F.conv2d(shifted, pos_w, None, stride, padding, dilation)
        grad_x = _excitation_grad(shifted, norm, g, lambda gn: torch.nn.grad.conv2d_input(
            x.shape, pos_w, gn, stride, padding, dilation))
        # the reference detaches the weights in the patched conv
        grad_w = torch.zeros_like(w) if ctx.needs_input_grad[1] else None
        grad_b = torch.zeros(w.shape[0], dtype=w.dtype, device=w.device) \
            if ctx.needs_input_grad[2] else None
        return grad_x, grad_w, grad_b, None, None, None


def pr_conv(x, w, b=None, stride=(1, 1), padding=(0, 0), dilation=(1, 1)):
    """Conv (x (B, Cin, H, W), w (Cout, Cin, kh, kw) OIHW) whose backward
    is the excitation rule (reference pr_conv2d):
      offset = min(x) over the whole tensor,
      norm = conv(x - offset, relu(w)),
      g_norm = g / (|norm| + 1e-10), 0 where norm < 1e-10,
      grad_x = (x - offset) * conv_input_grad(g_norm, relu(w));
    w and b get zero gradients."""
    return _PRConv.apply(x, w, b, tuple(stride), tuple(padding), tuple(dilation))


class _EBLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return F.linear(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        shifted = x - x.min()
        pos_w = F.relu(w)
        norm = F.linear(shifted, pos_w)
        grad_x = _excitation_grad(shifted, norm, g, lambda gn: gn @ pos_w)
        grad_w = torch.zeros_like(w) if ctx.needs_input_grad[1] else None
        grad_b = torch.zeros(w.shape[0], dtype=w.dtype, device=w.device) \
            if ctx.needs_input_grad[2] else None
        return grad_x, grad_w, grad_b


def eb_linear(x, w, b):
    """Linear layer (x (..., Din), w (Dout, Din) as nn.Linear's) with the
    pr_conv excitation rule as its backward (cim_tpu's eb_linear, whose w
    is (Din, Dout))."""
    return _EBLinear.apply(x, w, b)
