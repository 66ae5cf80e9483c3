#!/usr/bin/env python3
"""Host time per call of the RoIAlign forward's wrapper, on one CUDA card.

    python3 scripts/roi_align_fwd_host.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (e.g. this one, or an earlier
commit unpacked with ``git archive``). For each ROOT in the order given,
then again in reverse, a child process imports ``chip_smoke`` and
``cim_tpu_torch`` from ROOT and calls ``cim_tpu_torch.ops.roi_align.roi_align``
on the eval path's 1200-pass map (``chip_smoke.EVAL_FEAT``, valid
``EVAL_VALID``, bf16, N 2048 of which the last 48 are zero-area padding,
cap 4, drawn by ``chip_smoke._roi_case`` from ``chip_smoke.SEED``). It
prints the host's time a call, from the call to its return (the plan, the
allocations and the launches; the card runs behind), as perf_counter around
50 calls made back to back, the median of 5 such runs; beside it the
card's time of one call as ``chip_smoke.cuda_ms`` takes it. Where the
checkout's roi_align takes a batch of images (``FWD_MAX_BATCH``), it does
the same for a stack of 8 such maps with differing valid extents, as the
batched eval path calls it.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

CALLS, ROUNDS = 50, 5


def child(root: str):
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    from cim_tpu_torch.ops import roi_align as ra

    rng = np.random.RandomState(cs.SEED)
    feat, rois = cs._roi_case(rng, cs.EVAL_FEAT, cs.EVAL_VALID, 1 / 16, 2048, torch.bfloat16)
    time_calls(root, ra, "", (feat, rois, 7, 1 / 16, 0, 4, cs.EVAL_VALID))
    if hasattr(ra, "FWD_MAX_BATCH"):
        extents = cs.ROI_ALIGN_BATCHED_CASES[0][1]
        cases = [cs._roi_case(rng, cs.EVAL_FEAT, hw, 1 / 16, 2048, torch.bfloat16)
                 for hw in extents]
        feat = torch.stack([f for f, _ in cases]).contiguous()
        rois = torch.stack([r for _, r in cases]).contiguous()
        time_calls(root, ra, f" (a stack of {len(extents)})",
                   (feat, rois, 7, 1 / 16, 0, 4, extents))


def time_calls(root, ra, what, args):
    import numpy as np
    import torch

    import chip_smoke as cs

    with torch.no_grad():
        launches = ra.roi_align.kernel_launches
        for _ in range(3):
            ra.roi_align(*args)
        torch.cuda.synchronize()
        if ra.roi_align.kernel_launches != launches + 3:
            raise RuntimeError("roi_align did not launch its kernel")
        host = []
        for _ in range(ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CALLS):
                ra.roi_align(*args)
            host.append((time.perf_counter() - t0) / CALLS)
            torch.cuda.synchronize()
        one_ms = cs.cuda_ms(lambda: ra.roi_align(*args), 20)
    print(f"[host] {root}: roi_align{what} of {os.path.relpath(ra.__file__, root)}: host "
          f"{1e6 * float(np.median(host)):.1f} us a call (runs {[round(1e6 * h, 1) for h in host]}), "
          f"card {one_ms:.4f} ms one call", flush=True)


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return
    roots = sys.argv[1:]
    if not roots:
        raise SystemExit(__doc__.split("\n\n")[1])
    for root in [*roots, *roots[::-1]]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root], check=True)


if __name__ == "__main__":
    main()
