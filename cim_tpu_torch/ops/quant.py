"""Dynamic int8 products of the eval head (port of cim_tpu/ops/quant.py).

TPU.EVAL_INT8 runs MaskFuse's 3x3 conv and its first FC as w8a8:
symmetric round-half-to-even quantization to int8 in [-127, 127], with
per-output-channel weight scales and per-row (FC) or per-sample (conv)
activation scales, int32 accumulation, and a float32 dequantization. No
calibration data or converted checkpoint is needed: the float32 parameters
serve both paths. Eval only: round() has zero gradient.

The products are torch._int_mm (cuBLASLt's int8 GEMM on the card, an
exact int32 matmul on the CPU), where cim_tpu has XLA's dot_general and
conv_general_dilated with preferred_element_type=int32; cim_tpu has no
Pallas kernel here. The int32 sums are exact, so the accumulators do not
depend on the order of summation: the card's equal the CPU's bit for bit,
and every step before and after them is a correctly rounded float32
operation in the order cim_tpu takes it. The conv is 9 shifted GEMMs over
the zero-padded quantized input, one a tap, summed in int32: a full
im2col of a stack of 8 x 2048 ROIs would take 14.8 GB of int8.

torch._int_mm's shape rules on the card (cuBLASLt): more than 16 rows,
and the inner and output sizes multiples of 8. They are checked on every
device and a shape that breaks them raises: there is no fallback.
"""
from __future__ import annotations

import numpy as np
import torch

QMAX = 127.0
# cim_tpu's max|x| / 127 runs under jit, where XLA folds the division by a
# constant into a product with its float32 reciprocal: the port takes the
# same product, so both packages get the same scales
QINV = float(np.float32(1.0) / np.float32(QMAX))


def _scales(amax: torch.Tensor) -> torch.Tensor:
    """max|x| / 127 as cim_tpu computes it (a product with the float32
    reciprocal), at least 1e-12."""
    return torch.clamp(amax * QINV, min=1e-12)


def _absmax(x: torch.Tensor, dims) -> torch.Tensor:
    """max |x| over ``dims`` (kept), in float32: max(max x, -min x), with
    no |x| temporary the size of x."""
    return torch.maximum(x.amax(dim=dims, keepdim=True),
                         -x.amin(dim=dims, keepdim=True)).float()


def _quant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(x / scale), -127, 127) as int8; the quotient is float32
    (a bf16 x is widened exactly) and rounded half to even in place."""
    return (x / scale).round_().clamp_(-QMAX, QMAX).to(torch.int8)


def int_mm(a: torch.Tensor, b: torch.Tensor, what: str) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exact; raises where
    torch._int_mm's rules on the card fail (M > 16, K and N multiples of
    8). Counted in ``int_mm.calls``."""
    (m, k), n = a.shape, b.shape[1]
    if m <= 16 or k % 8 or n % 8:
        raise ValueError(
            f"{what}: an int8 product of ({m}, {k}) x ({k}, {n}) breaks torch._int_mm's "
            f"shape rules (more than 16 rows, inner and output sizes multiples of 8)")
    int_mm.calls += 1
    return torch._int_mm(a, b)


int_mm.calls = 0


def dense_accumulators(x: torch.Tensor, weight: torch.Tensor):
    """The int32 accumulators and scales of :func:`int8_dense`: x (M, K),
    weight (F, K) as nn.Linear holds it -> (acc (M, F) int32, sx (M, 1),
    sw (1, F))."""
    sx = _scales(_absmax(x, -1))
    sw = _scales(_absmax(weight, 1))  # (F, 1)
    acc = int_mm(_quant(x, sx), _quant(weight, sw).t(), "int8_dense")
    return acc, sx, sw.reshape(1, -1)


def int8_dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None):
    """x (..., K) @ weight (F, K)^T with per-row activation scales and
    per-output-column weight scales; float32 (..., F)."""
    lead = x.shape[:-1]
    acc, sx, sw = dense_accumulators(x.reshape(-1, x.shape[-1]), weight)
    out = acc.float().mul_(sx).mul_(sw)
    if bias is not None:
        out.add_(bias.float())
    return out.reshape(*lead, -1)


def conv_accumulators(x: torch.Tensor, weight: torch.Tensor, padding: int = 1):
    """The int32 accumulators and scales of :func:`int8_conv_nhwc`: x (N,
    H, W, Cin), weight (Cout, Cin, kh, kw) as nn.Conv2d holds it -> (acc
    (N, H', W', Cout) int32, sx (N, 1, 1, 1), sw (Cout,)).

    Per-sample activation scales (over H, W, Cin): the conv never mixes
    the N axis, so a pad row never moves a valid row's quantization."""
    n, h, w, cin = x.shape
    cout, _, kh, kw = weight.shape
    sx = _scales(_absmax(x, (1, 2, 3)))
    sw = _scales(_absmax(weight, (1, 2, 3)))  # (Cout, 1, 1, 1)
    xq = _quant(x, sx)
    wq = _quant(weight, sw)
    # (kh, kw, Cout, Cin): a tap's (Cout, Cin) block is contiguous, and its
    # transpose the (Cin, Cout) operand
    taps = wq.permute(2, 3, 0, 1).contiguous()
    xp = torch.nn.functional.pad(xq, (0, 0, padding, padding, padding, padding))
    oh, ow = h + 2 * padding - kh + 1, w + 2 * padding - kw + 1
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            rows = xp[:, dy:dy + oh, dx:dx + ow, :].reshape(n * oh * ow, cin)
            part = int_mm(rows, taps[dy, dx].t(), "int8_conv_nhwc")
            acc = part if acc is None else acc.add_(part)
    return acc.reshape(n, oh, ow, cout), sx, sw.reshape(-1)


def int8_conv_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
                   padding: int = 1):
    """Stride-1 conv with int8 operands: x (N, H, W, Cin) NHWC, weight
    (Cout, Cin, kh, kw); float32 (N, H', W', Cout)."""
    acc, sx, sw = conv_accumulators(x, weight, padding)
    out = acc.float().mul_(sx * sw.reshape(1, 1, 1, -1))
    if bias is not None:
        out.add_(bias.float())
    return out
