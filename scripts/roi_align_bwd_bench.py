#!/usr/bin/env python3
"""Time the RoIAlign backward kernel on one CUDA card at the train path's shapes.

    python3 scripts/roi_align_bwd_bench.py [--against DIR]

Builds ``cim_tpu_torch/csrc/roi_align_bwd.cu`` three ways into
``cim_tpu_torch/_build/``: as the package builds it, and with each of its
measurement switches (ROI_ALIGN_BWD_NO_ADD: g staged, nothing added;
ROI_ALIGN_BWD_NO_STAGE: added from shared memory that holds no g). With
``--against DIR`` it also builds ``DIR/roi_align_bwd.cu`` of the older
atomic-add interface (a zeroed f32 dF that the kernel adds into, cast to
the dtype afterwards), e.g. a copy of the file from an earlier commit with
its ``roi_align_common.cuh`` beside it, and times it in the same process.

The inputs are those of chip_smoke.py's roi_align_bwd phase (same seed, same
order): features 60x76 and 24x32 (scales 1200 and 480 of a 375x500 image)
and the padded 76x100 bucket, 1024 channels, N ROIs of which the last 48 are
zero-area padding with zero gradient. Each line gives the CUDA-event median
over 20 launches after two warm-up calls; the card's nvidia-smi name and
power limit come first. The switched builds give wrong sums by design; the
others are held to the plain version as chip_smoke.py holds them.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from cim_tpu_torch.ops import _build  # noqa: E402
from cim_tpu_torch.ops import roi_align as ra  # noqa: E402

SWITCHES = {"no_add": "-DROI_ALIGN_BWD_NO_ADD", "no_stage": "-DROI_ALIGN_BWD_NO_STAGE"}


def _nvcc(src: str, out_name: str, flags=()) -> ctypes.CDLL:
    out = os.path.join(_build.BUILD_DIR, out_name)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o", out, src],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(out)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--against", help="directory of an atomic-add roi_align_bwd.cu to time beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(f"[card] {cs.card_line()}", flush=True)

    argtypes = ra._kernel("roi_align_bwd").argtypes  # builds the package's kernel
    src = os.path.join(_build.CSRC_DIR, "roi_align_bwd.cu")
    jobs = {name: (src, f"roi_align_bwd_bench_{name}.so", [flag]) for name, flag in SWITCHES.items()}
    if args.against:
        jobs["against"] = (os.path.join(args.against, "roi_align_bwd.cu"),
                           "roi_align_bwd_bench_against.so", [])
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda job: _nvcc(*job), jobs.values())))
    fns = {"kernel": ra._kernel("roi_align_bwd")}
    for name, lib in libs.items():
        fns[name] = lib.roi_align_bwd
        fns[name].restype = ctypes.c_int
        fns[name].argtypes = argtypes[:15] if name == "against" else argtypes

    def run(name, g, rois, shape, valid, cap):
        h, w, c = shape
        n = rois.shape[0]
        head = (g.data_ptr(), rois.data_ptr())
        tail = (n, h, w, c, valid[0], valid[1], 7, 1 / 16, 0, cap, ra._DTYPE_CODES[g.dtype],
                torch.cuda.current_stream().cuda_stream)
        if name == "against":
            out = torch.zeros(shape, dtype=torch.float32, device="cuda")
            err = fns[name](*head, out.data_ptr(), *tail)
            out = out.to(g.dtype)
        else:
            plan = ra.bwd_launch_plan(h, w, c, g.device)
            scratch = torch.empty(ra._bwd_scratch_words(n, h, w, c, plan), dtype=torch.int32,
                                  device="cuda")
            out = torch.empty(shape, dtype=g.dtype, device="cuda")
            err = fns[name](*head, out.data_ptr(), *tail, scratch.data_ptr(), plan.splits, plan.smem)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return out

    rng = np.random.RandomState(cs.SEED + 3)
    t1200, t480 = ((60, 76, 1024), (60, 76)), ((24, 32, 1024), (24, 32))
    cases = [("train1200_bf16", t1200, 2048, torch.bfloat16, 4),
             ("train1200_bf16_n4096", t1200, 4096, torch.bfloat16, 4),
             ("train480_bf16", t480, 2048, torch.bfloat16, 4),
             ("pad76x100_f32", ((76, 100, 1024), (75, 100)), 2048, torch.float32, 4)]
    for case, (shape, valid), n, dtype, cap in cases:
        _, rois = cs._roi_case(rng, shape, valid, 1 / 16, n, dtype)
        g = torch.from_numpy(rng.randn(n, 7, 7, shape[2]).astype(np.float32)).cuda()
        g[-48:] = 0.0
        g = g.to(dtype)
        plain = ra.roi_align_backward_plain(g, rois, shape[0], shape[1], 7, 1 / 16, 0, cap, valid)
        mag = ra.roi_align_backward_plain(g.float().abs(), rois, shape[0], shape[1], 7, 1 / 16, 0,
                                          cap, valid)
        tol = cs.BWD_F32_REL * mag.max().item()
        if dtype == torch.bfloat16:
            tol += cs.BF16_REL * plain.float().abs().max().item()
        plan = ra.bwd_launch_plan(*shape, g.device)
        order = ["against", "kernel", "no_add", "no_stage", "kernel", "against"]
        for name in (o for o in order if o in fns):
            out = run(name, g, rois, shape, valid, cap)
            torch.cuda.synchronize()
            err = (out.float() - plain.float()).abs().max().item()
            if name in ("kernel", "against") and err > tol:
                raise RuntimeError(f"{case} {name}: max_abs_err {err} above {tol}")
            ms = cs.cuda_ms(lambda: run(name, g, rois, shape, valid, cap), 20)
            print(f"[bench] {case}: {name} {ms:.4f} ms (max_abs_err {err:.3g}, bound {tol:.3g}); "
                  f"plan {plan._asdict()}", flush=True)


if __name__ == "__main__":
    main()
