"""Host NMS for detections (port of cim_tpu/ops/nms.py:nms_np, soft_nms_np).

Pure numpy on the host, as in the reference. Greedy NMS calls the shared
C++ kernel of cim_tpu.native (built with g++ at first use), which
implements the reference cython_nms semantics.
"""
from __future__ import annotations

import numpy as np

from cim_tpu import native


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
