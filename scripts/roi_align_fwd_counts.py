#!/usr/bin/env python3
"""Count the RoIAlign forward kernel's work at the eval path's shapes, on the CPU.

    python3 scripts/roi_align_fwd_counts.py

For the inputs of chip_smoke.py's roi_align cases (chip_smoke.ROI_ALIGN_CASES,
drawn in the same order from the same seed), it prints:

- the raw taps, (bin, sample, corner) triples of nonzero weight, that a
  kernel gathering every tap from global memory reads;
- the merged taps (``chip_smoke.tap_cells``), (bin, cell) pairs of nonzero
  weight, that the slice kernel of csrc/roi_align_fwd.cu sums from shared
  memory, and the bytes they read there over all channel slices;
- the warp steps of one slice block, for the group of ROIs with the most:
  the kernel runs each warp's items (32 / lanes consecutive bins, in ROI
  order) to the largest row count times the largest column count among
  them, so a step is one shared-memory load a lane, and the share of the
  lanes' loads that are taps of their own item.

Taps come from ``ops/roi_align._taps``, the plain version's; a bin row's
feature rows are read off its first bin column, a bin column's feature
columns off its first bin row. The plan is ops/roi_align._fwd_plan for an
H100 (132 SMs, 232,448 bytes of shared memory a block). No card is needed:
these are counts, not times.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from cim_tpu_torch.ops import roi_align as ra  # noqa: E402

H100_SMEM_OPTIN, H100_SMS = 232448, 132
R = 7


def _distinct(idx):
    """Distinct values >= 0 along the first axis."""
    s = idx.sort(dim=0).values
    return (s[0] >= 0).long() + ((s[1:] != s[:-1]) & (s[1:] >= 0)).sum(0)


def main():
    rng = np.random.RandomState(cs.SEED)
    for name, shape, valid, scale, n, dtype, sr, cap in cs.ROI_ALIGN_CASES:
        _, rois = cs._roi_case(rng, shape, valid, scale, n, dtype, device="cpu")
        taps, _ = ra._taps(rois, shape[1], valid[0], valid[1], R, scale, sr, cap)
        idx, w = (torch.stack(t) for t in zip(*taps))  # (taps, N, R, R)
        raw = int((w != 0).sum())
        merged = cs.tap_cells(rois, shape[1], valid, scale, sr, cap)
        on = w != 0
        ny = _distinct(torch.where(on, idx // shape[1], -1)[:, :, :, 0])  # (N, R) bin rows
        nx = _distinct(torch.where(on, idx % shape[1], -1)[:, :, 0, :])  # (N, R) bin columns
        elem = torch.finfo(dtype).bits // 8
        plan = ra._fwd_plan(*valid, shape[2], elem, H100_SMEM_OPTIN, H100_SMS)
        lanes = max(1, plan.cs * elem // 16)
        per_warp = 32 // lanes
        worst = None
        for group in range(plan.groups):
            gy = ny[group::plan.groups].repeat_interleave(R, 1).reshape(-1)
            gx = nx[group::plan.groups].repeat(1, R).reshape(-1)
            pad = -len(gy) % per_warp
            gy = torch.cat([gy, gy.new_zeros(pad)]).reshape(-1, per_warp)
            gx = torch.cat([gx, gx.new_zeros(pad)]).reshape(-1, per_warp)
            steps = int((gy.max(1).values * gx.max(1).values).sum())
            own = int((gy * gx).sum())
            if worst is None or steps > worst[0]:
                worst = (steps, own)
        steps, own = worst
        print(f"[counts] {name}: features {shape} valid {valid} scale 1/{round(1 / scale)} N {n} "
              f"{str(dtype)[6:]} sampling_ratio {sr} cap {cap}, plan {plan._asdict()}: raw taps "
              f"{raw} ({raw * elem * shape[2] / 1e9:.2f} GB gathered), merged taps {merged} "
              f"({merged * elem * shape[2] / 1e9:.2f} GB of shared-memory reads); busiest block "
              f"{steps} warp steps of {per_warp} items, {100 * own / (steps * per_warp):.1f} % "
              f"of its lanes' loads their own taps", flush=True)


if __name__ == "__main__":
    main()
