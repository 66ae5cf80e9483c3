"""NMS (port of cim_tpu/ops/nms.py: greedy_nms_from_iou, nms_np, soft_nms_np).

- :func:`greedy_nms_from_iou`: exact greedy NMS over precomputed IoU
  matrices on the device, batched over leading axes (CIM mining's
  per-class seed NMS, reference lib/modeling/heads.py:237-258). CUDA
  tensors go to the hand-written kernel ``csrc/nms_from_iou.cu``, which
  never waits for the host; CPU tensors to :func:`greedy_nms_rounds`, the
  plain version, which the tests hold against cim_tpu.
- :func:`nms_np` / :func:`soft_nms_np`: host NMS for detections, numpy as
  in the reference. Greedy NMS calls the C++ kernel of cim_tpu_torch.native
  (built with g++ at first use), which implements the reference cython_nms
  semantics.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cim_tpu_torch import native
from cim_tpu_torch.ops import _build
from cim_tpu_torch.utils.trace import span

NEG_INF = -1e30

# candidates a row the kernel holds (csrc/nms_from_iou.cu, kMaxK)
MAX_CANDIDATES = 1024


def greedy_nms_from_iou(iou, scores, thresh, valid=None):
    """Exact greedy NMS given IoU matrices, batched over leading axes.

    iou: (..., N, N); scores: (..., N); valid: optional (..., N) bool
    (invalid entries are never kept and never suppress). Candidates go in
    descending score order, ties by index (stable sort); a candidate i is
    kept iff no kept higher-ranked candidate j overlaps it with
    ``iou[..., i, j] >= thresh``. Returns the (..., N) bool keep mask.

    On a CUDA device the kernel decides each batch row in one block and
    the host never waits (launches counted on
    ``greedy_nms_from_iou.kernel_launches``); it takes float32 IoU and at
    most MAX_CANDIDATES candidates. CPU tensors take greedy_nms_rounds.
    """
    if scores.device.type == "cuda":
        return _greedy_nms_cuda(iou, scores, thresh, valid)
    return greedy_nms_rounds(iou, scores, thresh, valid)


greedy_nms_from_iou.kernel_launches = 0


def greedy_nms_rounds(iou, scores, thresh, valid=None):
    """The plain version of :func:`greedy_nms_from_iou`, on any device.

    As in cim_tpu, the greedy outcome is resolved a "generation" of
    candidates per round with (N, N) reductions; the loop ends when no
    valid candidate is undecided, which costs one host sync per round and
    one more for the test that ends the loop (a cim.sync span each). A
    finished batch row is a fixed point of the round, so rows that finish
    early are unaffected by later rounds.
    """
    n = scores.shape[-1]
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    s = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    order = torch.sort(-s, dim=-1, stable=True).indices
    ar = torch.arange(n, device=scores.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(-1, order, ar)
    # m[..., i, j]: j is a higher-ranked overlapping candidate of i
    m = ((rank[..., None, :] < rank[..., :, None]) & (iou >= thresh)
         & valid[..., None, :] & valid[..., :, None])
    kept = torch.zeros_like(valid)
    suppressed = torch.zeros_like(valid)
    while True:
        undecided = (valid & ~kept & ~suppressed).any()
        with span("cim.sync"):
            if not bool(undecided):
                return kept
        blocked = (m & ~suppressed[..., None, :]).any(-1)
        kept = kept | (valid & ~suppressed & ~blocked)
        suppressed = suppressed | ((m & kept[..., None, :]).any(-1) & ~kept)


@functools.cache
def _kernel():
    """The launcher of csrc/nms_from_iou.cu, built on first use."""
    fn = _build.load("nms_from_iou").nms_from_iou
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_void_p]
    return fn


def _greedy_nms_cuda(iou, scores, thresh, valid):
    n = scores.shape[-1]
    lead = tuple(scores.shape[:-1])
    if tuple(iou.shape) != lead + (n, n):
        raise ValueError(f"iou must be {lead + (n, n)} for scores {tuple(scores.shape)}, "
                         f"got {tuple(iou.shape)}")
    if iou.dtype != torch.float32:
        raise TypeError(f"the NMS kernel takes float32 IoU, got {iou.dtype}")
    if scores.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"the NMS kernel takes float32, bfloat16 or float16 scores, "
                        f"got {scores.dtype}")
    if n > MAX_CANDIDATES:
        raise ValueError(f"the NMS kernel takes at most {MAX_CANDIDATES} candidates, got {n}")
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    if tuple(valid.shape) != tuple(scores.shape) or valid.dtype != torch.bool:
        raise ValueError(f"valid must be a bool tensor of shape {tuple(scores.shape)}")
    if iou.device != scores.device or valid.device != scores.device:
        raise ValueError("iou, scores and valid must be on one device")
    # a half score widens to float32 exactly: the same order and ties
    iou, scores, valid = iou.contiguous(), scores.float().contiguous(), valid.contiguous()
    keep = torch.empty(scores.shape, dtype=torch.bool, device=scores.device)
    batch = keep.numel() // n if n else 0
    if batch == 0:
        return keep
    err = _kernel()(iou.data_ptr(), scores.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                    batch, n, float(thresh),
                    torch.cuda.current_stream(scores.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nms_from_iou kernel launch failed with CUDA error {err}")
    greedy_nms_from_iou.kernel_launches += 1
    return keep


def nms_np(dets: np.ndarray, thresh: float) -> list:
    """Greedy NMS with reference cython_nms semantics.

    dets: (N, 5) [x1, y1, x2, y2, score]. Areas use the detectron +1
    convention and suppression is at ``ovr >= thresh``. Returns kept
    indices in descending score order.
    """
    if dets.shape[0] == 0:
        return []
    return list(native.nms(dets.astype(np.float32), float(thresh)))


def soft_nms_np(
    dets: np.ndarray,
    sigma: float = 0.5,
    overlap_thresh: float = 0.3,
    score_thresh: float = 0.001,
    method: str = "linear",
):
    """Soft-NMS with reference cython_nms.soft_nms semantics
    (lib/utils/boxes.py:327-345). Returns (dets_out, keep_indices)."""
    methods = {"hard": 0, "linear": 1, "gaussian": 2}
    if method not in methods:
        raise ValueError(f"Unknown soft_nms method: {method}")
    method_id = methods[method]

    boxes = dets.copy().astype(np.float32)
    n = boxes.shape[0]
    inds = np.arange(n)
    i = 0
    while i < n:
        # swap the best remaining box into position i
        maxpos = i + np.argmax(boxes[i:n, 4])
        boxes[[i, maxpos]] = boxes[[maxpos, i]]
        inds[[i, maxpos]] = inds[[maxpos, i]]
        tx1, ty1, tx2, ty2, _ = boxes[i]
        tarea = (tx2 - tx1 + 1) * (ty2 - ty1 + 1)

        pos = i + 1
        while pos < n:
            x1, y1, x2, y2, _ = boxes[pos]
            area = (x2 - x1 + 1) * (y2 - y1 + 1)
            iw = min(tx2, x2) - max(tx1, x1) + 1
            ih = min(ty2, y2) - max(ty1, y1) + 1
            if iw > 0 and ih > 0:
                ov = iw * ih / (tarea + area - iw * ih)
                if method_id == 1:  # linear
                    weight = 1.0 - ov if ov > overlap_thresh else 1.0
                elif method_id == 2:  # gaussian
                    weight = np.exp(-(ov * ov) / sigma)
                else:  # hard
                    weight = 0.0 if ov >= overlap_thresh else 1.0
                boxes[pos, 4] *= weight
                if boxes[pos, 4] < score_thresh:
                    # drop it: move the last box into its slot
                    boxes[pos] = boxes[n - 1]
                    inds[pos] = inds[n - 1]
                    n -= 1
                    pos -= 1
            pos += 1
        i += 1
    return boxes[:n], inds[:n]
