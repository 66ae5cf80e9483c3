#!/usr/bin/env python3
"""Time the RoIAlign forward kernel on one CUDA card at the eval path's shapes.

    python3 scripts/roi_align_fwd_bench.py [--against DIR ...] [--profile]

Builds ``cim_tpu_torch/csrc/roi_align_fwd.cu`` as the package builds it,
and two patched copies of it that exist only for measurement (PATCHES):
``no_sum``, the tap tables built and the slice staged, every bin written
as zero, no tap summed; and ``no_conflict``, as many cells read for every
tap, but neighbouring ones, free of bank conflicts (wrong sums). Each
``--against DIR`` also builds ``DIR/roi_align_fwd.cu``, e.g. a copy of the
file from an earlier commit with its ``roi_align_common.cuh`` beside it: of
the older interface (no scratch and no plan: the kernel of one block per
(ROI, bin) that gathered every raw tap from global memory) or of this one.
All are timed in the same process, in the order: the older builds, the
kernel, the patched copies, the kernel, the older builds in reverse. With
``--profile`` each build also runs 5 calls a case under torch.profiler, and
the device time of each of its kernels is printed.

The cases and their inputs are those of chip_smoke.py's roi_align phase
(``chip_smoke.ROI_ALIGN_CASES``, drawn in the same order from the same
seed): among them the maps of the eval path's five TTA scales of a 375x500
image, bf16, N 2048 of which the last 48 are zero-area padding, cap 4. Each
line gives two times of a call: ``one`` as chip_smoke.py takes it
(``chip_smoke.cuda_ms``: CUDA events around one call, the median of 20),
and ``b2b``, CUDA events around 20 calls made back to back, divided by 20
(the median of 3 such runs), which hides the host's time per call. The
card's nvidia-smi name and power limit come first, and the sums over an
eval image's 10 passes last. The patched builds give wrong sums by design;
the others are held to the plain version as chip_smoke.py holds them.
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

# each patched build: (text of the kernel's source, its replacement), each
# found exactly once
_LANE_CELL = "(threadIdx.x / lanes + {u}) % 4 * cs * static_cast<int>(sizeof(T))"
PATCHES = {
    "no_sum": [
        ("const int wy_n = __reduce_max_sync(0xffffffffu, ny);", "const int wy_n = 0;"),
        ("const int wx_n = __reduce_max_sync(0xffffffffu, nx);", "const int wx_n = 0;"),
    ],
    "no_conflict": [
        ("const unsigned char* row = fq + ey.x;", "const unsigned char* row = fq;"),
        ("load_vec<T, VB>(row + ex[u0 + u].x, v[u]);",
         f"load_vec<T, VB>(row + {_LANE_CELL.format(u='u0 + u')}, v[u]);"),
        ("load_vec<T, VB>(row + ex[u].x, v);",
         f"load_vec<T, VB>(row + {_LANE_CELL.format(u='u')}, v);"),
    ],
}


def _nvcc(src: str, out_name: str) -> ctypes.CDLL:
    out = os.path.join(_build.BUILD_DIR, out_name)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
                    "-o", out, src], check=True, capture_output=True, text=True)
    return ctypes.CDLL(out)


def _patched(name: str) -> str:
    """A copy of the kernel's source with PATCHES[name] applied, in the
    build directory; returns its path."""
    with open(os.path.join(_build.CSRC_DIR, "roi_align_fwd.cu")) as f:
        text = f.read()
    for old, new in PATCHES[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"patch {name}: {old!r} is not in the kernel's source exactly once")
        text = text.replace(old, new)
    path = os.path.join(_build.BUILD_DIR, f"roi_align_fwd_bench_{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def back_to_back_ms(fn, reps: int = 20, rounds: int = 3) -> float:
    """CUDA events around ``reps`` calls of fn made back to back, divided
    by ``reps``; the median of ``rounds`` such runs, after two warm-up calls."""
    fn()
    fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def _profile(case, name, fn, calls=5):
    """Device time of each kernel of ``calls`` calls of fn, per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = ("roi_align_fwd_kernel", "fwd_taps_kernel", "fwd_slice_kernel")
    kernels = {nm: sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and nm in e.key) / 1e3 / calls
               for nm in names}
    print(f"[profile] {case}: {name}: " + ", ".join(
        f"{nm} {ms:.4f} ms" for nm, ms in kernels.items() if ms > 0), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--against", action="append", default=[],
                        help="directory of another roi_align_fwd.cu to time beside (repeatable)")
    parser.add_argument("--profile", action="store_true",
                        help="also print each build's device time by kernel")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(f"[card] {cs.card_line()}", flush=True)

    argtypes = ra._kernel("roi_align_fwd").argtypes  # builds the package's kernel
    jobs = {name: (_patched(name), f"roi_align_fwd_bench_{name}.so") for name in PATCHES}
    older, plain_iface = [], set()
    for d in args.against:
        name = os.path.basename(os.path.normpath(d))
        path = os.path.join(d, "roi_align_fwd.cu")
        with open(path) as f:
            if "void* scratch" not in f.read():
                plain_iface.add(name)
        jobs[name] = (path, f"roi_align_fwd_bench_{name}.so")
        older.append(name)
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda job: _nvcc(*job), jobs.values())))
    fns = {"kernel": ra._kernel("roi_align_fwd")}
    for name, lib in libs.items():
        fns[name] = lib.roi_align_fwd
        fns[name].restype = ctypes.c_int
        fns[name].argtypes = argtypes[:15] if name in plain_iface else argtypes

    def run(name, feat, rois, shape, valid, scale, sr, cap):
        h, w, c = shape
        n = rois.shape[0]
        out = torch.empty((n, 7, 7, c), dtype=feat.dtype, device="cuda")
        head = (feat.data_ptr(), rois.data_ptr(), out.data_ptr(), n, h, w, c, valid[0], valid[1],
                7, scale, sr, cap, ra._DTYPE_CODES[feat.dtype],
                torch.cuda.current_stream().cuda_stream)
        if name in plain_iface:
            err = fns[name](*head)
        else:
            plan = ra.fwd_launch_plan(*valid, c, feat.dtype, feat.device)
            scratch = torch.empty(ra._fwd_scratch_words(n, 7, sr, cap), dtype=torch.int32,
                                  device="cuda")
            err = fns[name](*head, scratch.data_ptr(), plan.cs, plan.groups, plan.smem)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return out

    order = [*older, "kernel", *PATCHES, "kernel", *older[::-1]]
    image = {name: {"one": 0.0, "b2b": 0.0} for name in fns if name not in PATCHES}
    passes = {f"eval{t}_bf16" if t != 1200 else "eval_bf16" for t in cs.EVAL_PASS_MAPS}
    rng = np.random.RandomState(cs.SEED)
    for case, shape, valid, scale, n, dtype, sr, cap in cs.ROI_ALIGN_CASES:
        feat, rois = cs._roi_case(rng, shape, valid, scale, n, dtype)
        inputs = (feat, rois, shape, valid, scale, sr, cap)
        plain = ra.roi_align_plain(feat, rois, 7, scale, sr, cap, valid)
        tol = cs.F32_ATOL if dtype == torch.float32 else \
            cs.BF16_REL * feat.float().abs().max().item()
        plan = ra.fwd_launch_plan(*valid, shape[2], dtype, feat.device)
        seen = {}
        for name in order:
            out = run(name, *inputs)
            torch.cuda.synchronize()
            err = (out.float() - plain.float()).abs().max().item()
            if name not in PATCHES and err > tol:
                raise RuntimeError(f"{case} {name}: max_abs_err {err} above {tol}")
            one = cs.cuda_ms(lambda: run(name, *inputs), 20)
            b2b = back_to_back_ms(lambda: run(name, *inputs))
            seen.setdefault(name, []).append((one, b2b))
            print(f"[bench] {case}: {name} one {one:.4f} ms, b2b {b2b:.4f} ms "
                  f"(max_abs_err {err:.3g}, bound {tol:.3g}); plan {plan._asdict()}", flush=True)
        if args.profile:
            for name in fns:
                _profile(case, name, lambda: run(name, *inputs))
        if case in passes:
            for name, sums in image.items():
                sums["one"] += 2 * float(np.median([t[0] for t in seen[name]]))
                sums["b2b"] += 2 * float(np.median([t[1] for t in seen[name]]))
        del feat, rois, plain, out
    print("[bench] per eval image (10 passes, bf16, medians of each build's runs): " + ", ".join(
        f"{name} one {t['one']:.4f} ms, b2b {t['b2b']:.4f} ms" for name, t in image.items()),
        flush=True)


if __name__ == "__main__":
    main()
