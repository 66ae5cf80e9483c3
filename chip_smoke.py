#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cim_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of the repository

It needs a CUDA device and nvcc; without a device it exits non-zero and
prints no result. It imports no JAX and nothing of cim_tpu. Phases, each
of which fails the run:

  build            compile csrc/roi_align_fwd.cu and csrc/roi_align_bwd.cu
                   with nvcc into cim_tpu_torch/_build/, both at once
  roi_align        the forward kernel against its plain PyTorch version on
                   the card, at the eval path's shapes (the maps of all five
                   TTA scales, float32 and bf16, grid caps 4 and 2), at the
                   square image's 76x76 map, at the train path's buckets
                   (scales 480 and 1200, N 2048 and 4096) and at strides
                   8 and 32; each
                   twice, to the same bits, with its plan, and the kernel's
                   time summed over an eval image's 10 passes
  roi_align_bwd    the backward kernel against its plain version on the
                   card, at the train path's shapes (scales 480 and 1200,
                   N 2048 / 2047 / 4096 with zero-area padding ROIs,
                   float32 and bf16, grid caps 4 and 2) and at stride 8
                   (30 row bands, a part-filled channel slice); each
                   twice, to the same bits
  reference        the full-width model in float32: the card (kernels)
                   against the CPU (plain versions) on one small image with
                   two TTA passes
  eval main path   run_inference of the resnet50_voc config (bf16 compute,
                   RoIAlign grid cap 4, EVAL_BATCH 1) at full width with
                   seeded random weights over 4 synthetic 375x500 images
                   with 2000 proposals each: 10 TTA passes per image, NMS,
                   COCO box eval
  train_reference  the full-width model in float32, TF32 off, anti-noise
                   off: one microbatch (a 128x160 image, 64 proposals) on
                   the card (both kernels) against the CPU (plain
                   versions): every loss and the gradients of Box_Head and
                   Conv_Body.res4
  train main path  Trainer of the resnet50_voc config at full width (bf16
                   compute, RoIAlign cap 4, GRAD_ACCUM 4, seeded random
                   weights) on synthetic 375x500 batches: a warm step, then
                   3 timed steps at each of the scale-480 and scale-1200
                   buckets with 2000 proposals padded to 2048, then a warm
                   and a timed step at scale 1200 with 4000 padded to
                   4096; then a checkpoint save / load / one more step
                   against the uninterrupted trainer

With --profile, one more training step (scale 1200, 2048 proposals) runs
under torch.profiler and its device time by operator, by phase
(cim.forward, cim.losses, cim.mining, cim.backward, cim.optimizer) and of
each of the port's kernels is printed.

The card's nvidia-smi name and power limit come on the [device] line and
again on a line of their own; the line before the last is a JSON object
with the kernels' launches, errors, times and bounds; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from cim_tpu_torch.config import clone_cfg, load_cfg
from cim_tpu_torch.data import catalog
from cim_tpu_torch.data.loader import _bucket_hw, proposal_bucket
from cim_tpu_torch.data.synthetic import (
    make_microbatch,
    make_train_batch,
    write_synthetic_coco_dataset,
)
from cim_tpu_torch.data.transforms import scale_for_target
from cim_tpu_torch.engine.checkpoint import load_ckpt, save_ckpt
from cim_tpu_torch.engine.test import Evaluator
from cim_tpu_torch.engine.test_engine import get_roidb_and_dataset, run_inference
from cim_tpu_torch.engine.train import Trainer, losses_from_pseudo_labels, mine_pseudo_labels
from cim_tpu_torch.models.builder import build_model, frozen_paths_for, is_frozen
from cim_tpu_torch.models.layers import FrozenBatchNorm
from cim_tpu_torch.ops import _build
from cim_tpu_torch.ops import roi_align as ra
from cim_tpu_torch.ops.roi_align import (
    roi_align,
    roi_align_backward,
    roi_align_backward_plain,
    roi_align_plain,
)

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
N_IMAGES = 4
IMAGE_HW = (375, 500)
N_PROPS = 2000
# the 1200 pass of a 375x500 image: a 960x1216 canvas, 900x1200 content
EVAL_FEAT = (60, 76, 1024)
EVAL_VALID = (57, 75)
# the features of the eval path's TTA scales (each taken twice, with and
# without hflip) for a 375x500 image: Evaluator._fused_forward's canvas,
# ceil(0.75 t) x t rounded up to 64, holds content round(0.75 t) x t; the
# map is the canvas over 16, its valid extent the content over 16 rounded up
EVAL_PASS_MAPS = {
    480: ((24, 32, 1024), (23, 30)),
    576: ((28, 36, 1024), (27, 36)),
    688: ((36, 44, 1024), (33, 43)),
    864: ((44, 56, 1024), (41, 54)),
    1200: (EVAL_FEAT, EVAL_VALID),
}
F32_ATOL = 1e-5  # forward kernel vs plain in float32: sums in another order only
BF16_REL = 1e-2  # bf16: one output rounding, relative to max |output|
# backward: the kernel sums each cell in ROI order, the plain version's
# index_add_ on the card in a run-dependent one, so a cell's f32 sum may
# differ by a few ulp of the sum of its terms' magnitudes:
# bound = BWD_F32_REL * max over cells of sum |terms|
BWD_F32_REL = 1e-5
# the H100 SXM's published peaks: HBM bytes/s, and
# operations/s by input type (bf16 on the tensor cores; f32 outside them)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# the forward kernel's cases, drawn in this order from one generator seeded
# with SEED: (name, features, valid, scale, N, dtype, sampling_ratio, cap)
ROI_ALIGN_CASES = [
    ("eval_f32", EVAL_FEAT, EVAL_VALID, 1 / 16, 2048, torch.float32, 0, 4),
    ("eval_bf16", EVAL_FEAT, EVAL_VALID, 1 / 16, 2048, torch.bfloat16, 0, 4),
    ("eval_bf16_sr2", EVAL_FEAT, EVAL_VALID, 1 / 16, 2048, torch.bfloat16, 2, 4),
    ("eval_bf16_n2047", EVAL_FEAT, EVAL_VALID, 1 / 16, 2047, torch.bfloat16, 0, 4),
    ("eval_f32_n2047_cap2", EVAL_FEAT, EVAL_VALID, 1 / 16, 2047, torch.float32, 0, 2),
    ("stride8_bf16", (120, 152, 512), (113, 150), 1 / 8, 2048, torch.bfloat16, 0, 4),
    ("stride32_bf16", (30, 38, 2048), (29, 38), 1 / 32, 2048, torch.bfloat16, 0, 4),
    *((f"eval{t}_bf16", *EVAL_PASS_MAPS[t], 1 / 16, 2048, torch.bfloat16, 0, 4)
      for t in (480, 576, 688, 864)),
    # a square image's 1200 pass: the widest valid map of the eval path
    ("square1200_bf16", (76, 76, 1024), (75, 75), 1 / 16, 2048, torch.bfloat16, 0, 4),
    # the padded scale-1200 train bucket in float32: the narrowest f32 slice
    ("pad76x100_f32", (76, 100, 1024), (75, 100), 1 / 16, 2048, torch.float32, 0, 4),
    # the train path's: its buckets' whole maps are valid (scales 1200 and
    # 480 of a 375x500 image), N 2048 and the 4096 cap
    ("train1200_bf16", (60, 76, 1024), (60, 76), 1 / 16, 2048, torch.bfloat16, 0, 4),
    ("train480_bf16", (24, 32, 1024), (24, 32), 1 / 16, 2048, torch.bfloat16, 0, 4),
    ("train1200_bf16_n4096", (60, 76, 1024), (60, 76), 1 / 16, 4096, torch.bfloat16, 0, 4),
]
TRAIN_STEPS = 3  # timed steps per 2048-proposal bucket
TRAIN_SCALES = (480, 1200)
TRAIN_N_VALID = (2000, 4000)  # a typical COB count (bucket 2048), and bench.py's cap run (4096)


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    """Fail the run (unlike assert, kept under python -O)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()]


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() in ms, after two warm-up calls."""
    fn()
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def tap_cells(rois, width, valid, scale, sampling_ratio, cap) -> int:
    """Distinct (ROI, bin, feature cell) triples of nonzero bilinear weight:
    the multiply-adds per channel that RoIAlign, forward or backward, needs
    on these ROIs at the least (taps of one bin on one cell merged)."""
    taps, _ = ra._taps(rois, width, valid[0], valid[1], 7, scale, sampling_ratio, cap)
    idx = torch.stack([torch.where(w != 0, i, torch.full_like(i, -1)) for i, w in taps])
    s = idx.sort(dim=0).values
    return int((s[0] >= 0).sum()) + int(((s[1:] != s[:-1]) & (s[1:] >= 0)).sum())


def bound(n_bytes: float, ops: float, dtype):
    """(least time in ms, what sets it) at the card's published peaks."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ phases

def phase_build():
    """One nvcc per kernel source, all started together."""
    t0 = time.perf_counter()
    names = ("roi_align_fwd", "roi_align_bwd")
    with ThreadPoolExecutor(len(names)) as pool:
        paths = list(pool.map(_build.build, names))
    log(f"[build] {[os.path.relpath(p, REPO) for p in paths]} built in "
        f"{time.perf_counter() - t0:.2f} s")


def _roi_case(rng, feat_hw_c, valid, scale, n, dtype, device="cuda"):
    """Features with a zeroed pad (as the backbone leaves them) and n seeded
    rois across the valid canvas, the last 48 zero-area padding rows."""
    h, w, c = feat_hw_c
    feat = torch.zeros((h, w, c), device=device)
    feat[: valid[0], : valid[1]] = torch.from_numpy(
        rng.randn(valid[0], valid[1], c).astype(np.float32)).to(device)
    img_h, img_w = valid[0] / scale, valid[1] / scale
    x1 = rng.uniform(0, img_w * 0.9, n)
    y1 = rng.uniform(0, img_h * 0.9, n)
    x2 = np.minimum(x1 + rng.uniform(8, img_w * 0.6, n), img_w - 1)
    y2 = np.minimum(y1 + rng.uniform(8, img_h * 0.6, n), img_h - 1)
    rois = np.stack([x1, y1, x2, y2], -1).astype(np.float32)
    rois[-48:] = 0.0
    return feat.to(dtype).contiguous(), torch.from_numpy(rois).to(device)


def phase_roi_align():
    """Forward kernel vs plain version on the same inputs, each case twice
    to the same bits; returns the eval-shape bf16 case (the eval main
    path's) for the kernels line, with the kernel's time summed over the
    10 passes of an eval image."""
    rng = np.random.RandomState(SEED)
    main_case, times = None, {}
    with torch.no_grad():
        for name, shape, valid, scale, n, dtype, sr, cap in ROI_ALIGN_CASES:
            feat, rois = _roi_case(rng, shape, valid, scale, n, dtype)
            args = (feat, rois, 7, scale, sr, cap, valid)
            plan = ra.fwd_launch_plan(*valid, shape[2], dtype, rois.device)
            out = roi_align(*args)
            again = roi_align(*args)
            torch.cuda.synchronize()
            ref = roi_align_plain(*args)
            check(out.shape == ref.shape == (n, 7, 7, shape[2]) and out.dtype == dtype,
                  f"{name}: output shape and dtype")
            check(torch.equal(out, again), f"{name}: two runs give the same bits")
            err = (out.float() - ref.float()).abs().max().item()
            fmax = feat.float().abs().max().item()
            tol = F32_ATOL if dtype == torch.float32 else BF16_REL * fmax
            k_ms = cuda_ms(lambda: roi_align(*args), 20)
            p_ms = cuda_ms(lambda: roi_align_plain(*args), 5)
            # F's valid cells only: the function reads no cell of the pad
            n_bytes = valid[0] * valid[1] * shape[2] * feat.element_size() \
                + rois.numel() * 4 + out.numel() * out.element_size()
            cells = tap_cells(rois, shape[1], valid, scale, sr, cap)
            b_ms, b_by = bound(n_bytes, 2.0 * shape[2] * cells, dtype)
            times[name] = k_ms
            log(f"[roi_align] {name}: features {shape} valid {valid} scale 1/{round(1 / scale)} "
                f"N {n} {str(dtype)[6:]} sampling_ratio {sr} cap {cap}, plan {plan._asdict()}: "
                f"max_abs_err {err:.3g} (bound {tol:.3g}), two runs the same bits, "
                f"kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
                f"bound {b_ms:.4f} ms by {b_by} ({cells} tap cells, {n_bytes / 1e6:.1f} MB)")
            check(err <= tol, f"{name}: kernel agrees with the plain version")
            if name == "eval_bf16":
                main_case = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                             "plan": plan._asdict()}
            del feat, rois, out, again, ref
    passes = {t: times[f"eval{t}_bf16" if t != 1200 else "eval_bf16"] for t in EVAL_PASS_MAPS}
    main_case["eval_image_ms"] = 2 * sum(passes.values())
    log(f"[roi_align] per eval image (10 passes: each scale with and without hflip, "
        f"bf16, N 2048, cap 4): {main_case['eval_image_ms']:.4f} ms of kernel time "
        f"({', '.join(f'{t}: 2 x {ms:.4f}' for t, ms in passes.items())})")
    return main_case


def phase_roi_align_bwd():
    """Backward kernel vs plain version: the gradient of features
    (H, W, 1024) through N ROIs of which the last 48 are zero-area padding
    with zero gradient (as the losses leave them). The train main path's
    shapes come first: a 375x500 image at scale 1200 (target over the
    long side: a 960x1216 bucket, 60x76 features) and 480 (384x512, 24x32),
    N 2048 and the 4096 cap. Then zero-padded buckets with a smaller valid
    extent, float32, N 2047 and grid cap 2, and the stride-8 map of the
    1200 pass (120x152x512: 30 row bands of the kernel's plan, half a
    channel slice). Each case runs twice and must give the same bits: the
    kernel sums in a fixed order. Returns the scale-1200 bf16 N 2048 case
    (the train main path's) for the kernels line."""
    rng = np.random.RandomState(SEED + 3)
    t1200, t480 = ((60, 76, 1024), (60, 76)), ((24, 32, 1024), (24, 32))
    p1200, p480 = ((76, 100, 1024), (75, 100)), ((32, 40, 1024), (30, 40))
    s8 = ((120, 152, 512), (113, 150))
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # (name, (features, valid), scale, N, dtype, cap)
        ("train1200_bf16", t1200, 1 / 16, 2048, bf16, 4),
        ("train1200_bf16_n4096", t1200, 1 / 16, 4096, bf16, 4),
        ("train480_bf16", t480, 1 / 16, 2048, bf16, 4),
        ("pad76x100_f32", p1200, 1 / 16, 2048, f32, 4),
        ("pad76x100_bf16_n2047_cap2", p1200, 1 / 16, 2047, bf16, 2),
        ("pad32x40_f32_n2047", p480, 1 / 16, 2047, f32, 4),
        ("pad32x40_f32_cap2", p480, 1 / 16, 2048, f32, 2),
        ("stride8_bf16_bands", s8, 1 / 8, 2048, bf16, 4),
    ]
    main_case = None
    for name, (shape, valid), scale, n, dtype, cap in cases:
        _, rois = _roi_case(rng, shape, valid, scale, n, dtype)
        g = torch.from_numpy(rng.randn(n, 7, 7, shape[2]).astype(np.float32)).cuda()
        g[-48:] = 0.0
        g = g.to(dtype)
        args = (rois, shape[0], shape[1], 7, scale, 0, cap, valid)
        plan = ra.bwd_launch_plan(*shape, rois.device)
        out = roi_align_backward(g, *args)
        again = roi_align_backward(g, *args)
        torch.cuda.synchronize()
        ref = roi_align_backward_plain(g, *args)
        mag = roi_align_backward_plain(g.float().abs(), *args)  # sum |terms| per cell
        check(out.shape == ref.shape == shape and out.dtype == dtype,
              f"{name}: output shape and dtype")
        check(not out[valid[0]:].any() and not out[:, valid[1]:].any(),
              f"{name}: the pad of the bucket gets zero gradient")
        check(torch.equal(out, again), f"{name}: two runs give the same bits")
        err = (out.float() - ref.float()).abs().max().item()
        tol = BWD_F32_REL * mag.abs().max().item()
        if dtype == bf16:
            tol += BF16_REL * ref.float().abs().max().item()
        k_ms = cuda_ms(lambda: roi_align_backward(g, *args), 20)
        p_ms = cuda_ms(lambda: roi_align_backward_plain(g, *args), 3)
        n_bytes = g.numel() * g.element_size() + rois.numel() * 4 + out.numel() * out.element_size()
        cells = tap_cells(rois, shape[1], valid, scale, 0, cap)
        b_ms, b_by = bound(n_bytes, 2.0 * shape[2] * cells, dtype)
        log(f"[roi_align_bwd] {name}: features {shape} valid {valid} scale 1/{round(1 / scale)} "
            f"N {n} {str(dtype)[6:]} cap {cap}, plan {plan._asdict()}: max_abs_err {err:.3g} "
            f"(bound {tol:.3g}: f32 sums in another order than the plain version's"
            f"{', plus one bf16 rounding' if dtype == bf16 else ''}), two runs the same bits, "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by} "
            f"({cells} tap cells, {n_bytes / 1e6:.1f} MB)")
        check(err <= tol, f"{name}: backward kernel agrees with the plain version")
        if name == "train1200_bf16":
            main_case = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                         "plan": plan._asdict()}
        del out, again, ref, mag, g
    return main_case


def _smoke_cfg(data_dir, props):
    cfg = load_cfg(os.path.join(REPO, "configs", "resnet50_voc.yaml"))
    cfg.TPU.PALLAS_ROI_ALIGN = True  # bench.py's choice for a non-CPU backend: cap 4
    cfg.TPU.EVAL_BATCH = 1
    cfg.TPU.PRECISION = "bf16_compute"
    cfg.DATA_DIR = data_dir
    cfg.TEST.DATASETS = ("chip_smoke_synthetic",)
    cfg.TEST.PROPOSAL_FILES = (props,)
    return cfg


@torch.no_grad()
def _randomize_frozen_bn(model, gen):
    for m in model.modules():
        if isinstance(m, FrozenBatchNorm):
            n = m.running_mean.numel()

            def draw(lo, hi):
                return torch.rand(n, generator=gen, device=gen.device) * (hi - lo) + lo

            m.running_mean.copy_(draw(-0.1, 0.1))
            m.running_var.copy_(draw(0.5, 1.5))
            m.weight.copy_(draw(0.5, 1.5))
            m.bias.copy_(draw(-0.1, 0.1))


def _image_loader(entry):
    r = np.random.RandomState(SEED + entry["id"])
    return r.randint(0, 256, (entry["height"], entry["width"], 3)).astype(np.uint8)


def phase_reference(cfg, model):
    """The full-width model in float32, TF32 off: the card (RoIAlign kernel)
    against the CPU (plain version), one 120x160 image, hflip + identity."""
    cfg = clone_cfg(cfg)
    cfg.TPU.PRECISION = "f32"
    cfg.TEST.SCALE = 160
    cfg.TEST.BBOX_AUG.SCALES = ()
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(SEED + 1)
    im = rng.randint(0, 256, (120, 160, 3)).astype(np.uint8)
    x1, y1 = rng.uniform(0, 140, 64), rng.uniform(0, 100, 64)
    boxes = np.stack([x1, y1, np.minimum(x1 + rng.uniform(8, 90, 64), 159),
                      np.minimum(y1 + rng.uniform(8, 70, 64), 119)], -1).astype(np.float32)
    masks = (rng.rand(64, 7, 7) > 0.4).astype(np.float32)
    scores = {}
    for device in ("cuda", "cpu"):
        m = build_model(cfg, device=device)
        m.load_state_dict(state)
        scores[device], _ = Evaluator(cfg, m, device=device).im_detect_all(im, boxes, masks)
        del m
    err = np.abs(scores["cuda"] - scores["cpu"]).max()
    log(f"[reference] float32 full-width model, 2 TTA passes, 64 proposals: "
        f"card vs CPU max_abs_err {err:.3g} (scores up to {scores['cpu'].max():.3g})")
    np.testing.assert_allclose(scores["cuda"], scores["cpu"], rtol=2e-3, atol=2e-5)


class _TimedEvaluator(Evaluator):
    """Evaluator that records each image's TTA time (host clock around
    work that ends in a device-to-host copy and a synchronize)."""

    def __init__(self, cfg, model):
        super().__init__(cfg, model, device="cuda")
        self.seconds = []

    def im_detect_all(self, im, boxes, masks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = super().im_detect_all(im, boxes, masks)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        return out


def phase_main_path(work_dir, card):
    t0 = time.perf_counter()
    ann, props = write_synthetic_coco_dataset(
        work_dir, N_IMAGES, N_PROPS, np.random.RandomState(SEED),
        image_hw=IMAGE_HW, write_jpegs=False,
    )
    catalog.register_dataset("chip_smoke_synthetic", {
        catalog.IM_DIR: work_dir, catalog.ANN_FN: ann,
    })
    cfg = _smoke_cfg(work_dir, props)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = build_model(cfg, device="cuda", generator=gen)
    _randomize_frozen_bn(model, gen)
    n_params = sum(p.numel() for p in model.parameters())
    passes = Evaluator.tta_pass_list(cfg)
    log(f"[main] resnet50_voc: {n_params} params, {len(passes)} TTA passes {passes}, "
        f"set-up {time.perf_counter() - t0:.1f} s")

    phase_reference(cfg, model)

    # one warm image outside the counted run (cuDNN algorithm choice, allocator)
    evaluator = _TimedEvaluator(cfg, model)
    roidb = get_roidb_and_dataset(cfg, cfg.TEST.DATASETS[0], props)[0]
    evaluator.im_detect_all(_image_loader(roidb[0]), roidb[0]["boxes"], roidb[0]["masks"])
    warm_s = evaluator.seconds.pop()

    torch.cuda.reset_peak_memory_stats()
    roi_align.kernel_launches = 0
    roi_align_backward.kernel_launches = 0
    t0 = time.perf_counter()
    results, all_boxes, all_scores = run_inference(
        cfg, model, os.path.join(work_dir, "out"), image_loader=_image_loader,
        evaluator=evaluator,
    )
    e2e_s = time.perf_counter() - t0
    launches = roi_align.kernel_launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check(launches == N_IMAGES * len(passes),
          f"{launches} roi_align kernel launches for {N_IMAGES} images x {len(passes)} passes")
    check(roi_align_backward.kernel_launches == 0, "eval launches no backward kernel")
    check(len(all_scores) == N_IMAGES, "one score record per image")
    for name, rec in all_scores.items():
        s = rec["scores"]
        check(s.shape == (N_PROPS, cfg.MODEL.NUM_CLASSES), f"{name}: scores shape {s.shape}")
        check(np.isfinite(s).all() and s.min() >= 0.0 and s.max() <= 1.0,
              f"{name}: scores finite in [0, 1]")
        check(s.std() > 0, f"{name}: scores not constant")
    check(len(all_boxes) == cfg.MODEL.NUM_CLASSES + 1
          and all(len(all_boxes[j]) == N_IMAGES for j in range(1, len(all_boxes))),
          "detections for every class and image")
    check(np.isfinite(results["AP"]) and np.isfinite(results["AP50"]), "finite COCO AP")

    per_image = evaluator.seconds
    log(f"[main] {card}: fused TTA s/image median {np.median(per_image):.4f} "
        f"(each {[round(s, 4) for s in per_image]}; warm-up image {warm_s:.3f} s), "
        f"run_inference end to end {e2e_s / N_IMAGES:.4f} s/image incl. NMS + COCO eval, "
        f"peak device memory {peak_gb:.2f} GB, roi_align kernel launches {launches}")
    log(f"[main] COCO box eval on random weights: AP {results['AP']:.4f}, "
        f"AP50 {results['AP50']:.4f}")
    return launches, evaluator, roidb


def _log_port_kernels(events, device_ms=None):
    """Device time of each of the port's own kernels, however small (the
    RoIAlign forward is two, the backward three), and its share of
    ``device_ms`` where given."""
    from torch.autograd import DeviceType

    for name in ("fwd_taps_kernel", "fwd_slice_kernel", "bwd_taps_kernel", "bwd_tile_kernel",
                 "bwd_sum_kernel"):
        found = [e for e in events if e.device_type == DeviceType.CUDA and name in e.key]
        ms = sum(e.self_device_time_total for e in found) / 1e3
        share = f" ({100 * ms / device_ms:.2f} % of device busy)" if device_ms else ""
        log(f"[profile] {name}: device {ms:.3f} ms in {sum(e.count for e in found)} launches{share}")


def phase_profile(evaluator, entry):
    """Device time of one image's TTA by operator, against the median
    unprofiled s/image of the main path (the device's busy share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    median_ms = 1e3 * float(np.median(evaluator.seconds))
    im = _image_loader(entry)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        evaluator.im_detect_all(im, entry["boxes"], entry["masks"])
        torch.cuda.synchronize()
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3
    log(f"[profile] one image: device busy {device_ms:.1f} ms of the {median_ms:.1f} ms "
        f"median unprofiled image ({100 * device_ms / median_ms:.1f} %)")
    _log_port_kernels(events, device_ms)
    log(events.table(sort_by="self_device_time_total", row_limit=30, max_name_column_width=70))


# ------------------------------------------------------------- training

def _train_cfg():
    cfg = load_cfg(os.path.join(REPO, "configs", "resnet50_voc.yaml"))
    cfg.TPU.PALLAS_ROI_ALIGN = True  # bench.py's choice for a non-CPU backend: cap 4
    cfg.TPU.PRECISION = "bf16_compute"
    return cfg


def _train_bucket(cfg, scale):
    """The loader's image bucket of a 375x500 image at ``scale``."""
    s = scale_for_target(IMAGE_HW, scale, cfg.TRAIN.MAX_SIZE)
    return _bucket_hw(int(round(IMAGE_HW[0] * s)), int(round(IMAGE_HW[1] * s)),
                      int(cfg.TPU.PAD_MULTIPLE))


def _train_batch(cfg, rng, scale, n_valid):
    """One step's synthetic batch (leading GRAD_ACCUM axis), built as
    bench.py builds its batches."""
    batch = make_train_batch(rng, 1, cfg.TPU.GRAD_ACCUM, image_hw=_train_bucket(cfg, scale),
                             n_props=proposal_bucket(cfg, n_valid), n_valid=n_valid,
                             num_classes=cfg.MODEL.NUM_CLASSES)
    return {k: v[0] for k, v in batch.items()}


def phase_train_reference():
    """One float32 microbatch, card vs CPU, from one set of weights: every
    loss metric within rtol 1e-4 (atol 1e-6), and each gradient tensor of
    Box_Head and Conv_Body.res4 within 1e-2 of its CPU norm,
    ||g_card - g_cpu|| <= 1e-2 ||g_cpu||. The bound is not float32
    rounding alone: ReLU units whose input lies within rounding of zero
    switch between devices, and each switched (unit, proposal) pair moves
    the weight gradients by a whole proposal's share. On the CPU
    (scripts/torch_grad_sensitivity.py), relative noise of 1e-5 on the
    weights moves these gradients by up to 5.9e-3 in norm and 2.3e-2 in
    their largest element; a wrong kernel moves them by order one. The
    kernel itself is held to its plain version within float32 rounding in
    phase roi_align_bwd.

    Both devices take the pseudo labels that the CPU mined: with random
    weights the heads' scores are nearly uniform, so mining's sorts and
    argmaxes sit on near-ties (relative noise of 1e-5 on the scores changes
    the mined counts in 4 of 5 draws on the CPU, same script). How many
    rows the card's own mining labels differently is printed.
    """
    cfg = _train_cfg()
    cfg.TPU.PRECISION = "f32"
    cfg.TPU.GRAD_ACCUM = 1
    cfg.Anti_noise_sampling = False
    rng = np.random.RandomState(SEED + 2)
    mb = make_microbatch(rng, image_hw=(128, 160), n_props=64, n_valid=60,
                         num_classes=cfg.MODEL.NUM_CLASSES)
    batch = {k: v[None] for k, v in mb.items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    card = Trainer(cfg, device="cuda", init_generator=gen)
    _randomize_frozen_bn(card.model, gen)
    host = Trainer(cfg, device="cpu")
    host.load_weights({k: v.detach().cpu() for k, v in card.model.state_dict().items()})
    fwd0, bwd0 = roi_align.kernel_launches, roi_align_backward.kernel_launches
    runs = {}
    for name, t in (("cpu", host), ("cuda", card)):
        b = t.microbatch(batch, 0)
        out = t.model(b["image"], b["rois"], b["masks"], b["valid"], im_hw=b["image_hw"])
        runs[name] = (t, b, out, mine_pseudo_labels(cfg, out, b))
    shared = runs["cpu"][3]
    differ = sum(int((a.pseudo_labels.cpu() != p.pseudo_labels).any(dim=1).sum())
                 for a, p in zip(runs["cuda"][3], shared))
    out = {}
    for name, (t, b, o, _) in runs.items():
        pseudo = [type(p)(*(x.to(t.device) for x in p)) for p in shared]
        losses = losses_from_pseudo_labels(cfg, o, b, pseudo)
        losses["total_loss"].backward()
        grads = {n: p.grad.detach().cpu() for n, p in t.model.named_parameters()
                 if n.startswith(("Box_Head.", "Conv_Body.res4."))}
        out[name] = ({k: v.item() for k, v in losses.items()}, grads)
    check(roi_align.kernel_launches == fwd0 + 1 and roi_align_backward.kernel_launches == bwd0 + 1,
          "the card's microbatch ran both kernels once")
    (lc, gc), (lh, gh) = out["cuda"], out["cpu"]
    log(f"[train_reference] float32 full width, 64 proposals: the card's own mining labels "
        f"{differ} rows of {len(shared)} branches differently from the CPU's; with the CPU's "
        f"pseudo labels, losses card {lc} / CPU {lh}")
    for k, v in lh.items():
        check(np.isfinite(lc[k]) and abs(lc[k] - v) <= 1e-6 + 1e-4 * abs(v),
              f"train_reference: {k} card {lc[k]} vs CPU {v}")
    worst = max(((gc[n] - gh[n]).norm().item() / max(gh[n].norm().item(), 1e-30), n) for n in gh)
    worst_el = max(((gc[n] - gh[n]).abs().max().item() / max(gh[n].abs().max().item(), 1e-30), n)
                   for n in gh)
    log(f"[train_reference] {len(gh)} gradient tensors of Box_Head and Conv_Body.res4: "
        f"worst ||card - CPU|| / ||CPU|| {worst[0]:.3g} ({worst[1]}); worst "
        f"max|card - CPU| / max|CPU| {worst_el[0]:.3g} ({worst_el[1]})")
    check(worst[0] <= 1e-2, f"train_reference: gradient of {worst[1]} agrees")
    check(lh["has_gt_0"] == 1.0, "the reference microbatch mined a pseudo-GT")


def _timed_steps(trainer, batch, n):
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.step(batch)  # ends in a device-to-host copy of the metrics
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0, m, list(trainer.last_nms_rounds)))
    return out


def phase_train(card, work_dir, profile=False):
    """The slice's main path: the resnet50_voc Trainer at full width.
    Returns the forward and backward kernels' launches in it."""
    cfg = _train_cfg()
    accum = cfg.TPU.GRAD_ACCUM
    rng = np.random.RandomState(SEED + 4)
    t0 = time.perf_counter()
    batches = {scale: _train_batch(cfg, rng, scale, TRAIN_N_VALID[0]) for scale in TRAIN_SCALES}
    batches["4096"] = _train_batch(cfg, rng, TRAIN_SCALES[-1], TRAIN_N_VALID[1])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    trainer = Trainer(cfg, device="cuda", seed=SEED, init_generator=gen)
    _randomize_frozen_bn(trainer.model, gen)
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    log(f"[train] resnet50_voc: GRAD_ACCUM {accum}, buckets "
        f"{ {k: tuple(b['image'].shape[1:3]) + (b['rois'].shape[1],) for k, b in batches.items()} }, "
        f"set-up {time.perf_counter() - t0:.1f} s")

    roi_align.kernel_launches = 0
    roi_align_backward.kernel_launches = 0
    runs, peak_gb = {}, {}
    for key, n in [*((s, TRAIN_STEPS) for s in TRAIN_SCALES), ("4096", 1)]:
        batch = batches[key]
        torch.cuda.reset_peak_memory_stats()
        runs[f"warm {key}"] = _timed_steps(trainer, batch, 1)
        runs[key] = _timed_steps(trainer, batch, n)
        peak_gb[key] = torch.cuda.max_memory_allocated() / 1e9
    n_steps = sum(len(v) for v in runs.values())
    fwd, bwd = roi_align.kernel_launches, roi_align_backward.kernel_launches

    check(fwd == bwd == n_steps * accum,
          f"{fwd} forward / {bwd} backward kernel launches for {n_steps} steps x {accum}")
    for key, steps in runs.items():
        for _, m, _ in steps:
            check(all(np.isfinite(v) for v in m.values()), f"{key}: finite losses {m}")
    frozen = frozen_paths_for(cfg)
    for n, p in trainer.model.named_parameters():
        same = torch.equal(p.detach(), before[n])
        if n == "cls_iou_model.detector.bias":
            # the detector's softmax runs over proposals, so a per-class
            # bias cancels: its gradient is zero but for rounding, and a
            # bias has no weight decay
            continue
        check(same == is_frozen(n, frozen),
              f"{n}: {'unchanged' if same else 'moved'} (frozen: {is_frozen(n, frozen)})")
    for key in [*TRAIN_SCALES, "4096"]:
        secs = [s for s, _, _ in runs[key]]
        _, last, rounds = runs[key][-1]
        log(f"[train] {card}: bucket {key}: s/step median {np.median(secs):.4f} "
            f"(each {[round(s, 4) for s in secs]}), {accum / np.median(secs):.2f} images/s, "
            f"peak device memory {peak_gb[key]:.2f} GB; "
            f"losses {({k: round(v, 4) for k, v in last.items() if 'loss' in k})}, "
            f"mined_gt {[round(last[f'mined_gt_{k}'], 1) for k in range(cfg.REFINE_TIMES)]}, "
            f"NMS rounds of its last step {rounds}")
    log(f"[train] warm-up steps s: {[round(runs[k][0][0], 3) for k in runs if 'warm' in str(k)]}; "
        f"launches forward {fwd}, backward {bwd}")

    # checkpoint: save, load into a fresh trainer, one more step on both
    path = save_ckpt(os.path.join(work_dir, "ckpt"), trainer)
    resumed = Trainer(cfg, device="cuda", seed=SEED + 99)
    load_ckpt(os.path.dirname(path), resumed)
    check(resumed.step_count == trainer.step_count and resumed.seed == trainer.seed,
          "resumed trainer's step and seed")
    batch = batches[TRAIN_SCALES[0]]
    m_run, m_res = trainer.step(batch), resumed.step(batch)
    for k, v in m_run.items():
        check(abs(m_res[k] - v) <= 1e-6 + 1e-5 * abs(v),
              f"checkpoint: resumed {k} {m_res[k]} vs uninterrupted {v}")
    log(f"[train] checkpoint {os.path.basename(path)} ({os.path.getsize(path) / 1e9:.2f} GB): "
        f"resumed step total_loss {m_res['total_loss']:.6f} vs uninterrupted "
        f"{m_run['total_loss']:.6f}")
    del resumed
    if profile:
        phase_train_profile(trainer, batches[TRAIN_SCALES[-1]], runs[TRAIN_SCALES[-1]])
    return fwd, bwd


def phase_train_profile(trainer, batch, timed):
    """Device time of one training step by operator and by phase, against
    the median unprofiled s/step of its bucket."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    median_ms = 1e3 * float(np.median([s for s, _, _ in timed]))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step(batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    # kernels and copies only: the cim.* labels also appear as device-side
    # ranges, which span idle time and would count their kernels twice
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA and not e.key.startswith("cim.")) / 1e3
    log(f"[profile] one train step: device busy {device_ms:.1f} ms of the {wall_ms:.1f} ms "
        f"profiled step ({100 * device_ms / wall_ms:.1f} %) and of the {median_ms:.1f} ms "
        f"median unprofiled step ({100 * device_ms / median_ms:.1f} %)")
    # per phase: host time in the range, and device time of the kernels
    # launched from it (the backward's run on autograd's own thread, so
    # they count under no label: the device busy time less the others)
    for e in events:
        if e.key.startswith("cim.") and e.device_type == DeviceType.CPU:
            log(f"[profile] {e.key}: {e.count} ranges, host {e.cpu_time_total / 1e3:.1f} ms, "
                f"device {e.device_time_total / 1e3:.1f} ms")
    _log_port_kernels(events)
    log(events.table(sort_by="self_device_time_total", row_limit=40, max_name_column_width=70))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile one image of the eval path and one train step")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {card}")
    t_start = time.perf_counter()

    phase_build()
    fwd_kernel = phase_roi_align()
    bwd_kernel = phase_roi_align_bwd()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work_dir:
        eval_launches, evaluator, roidb = phase_main_path(work_dir, card)
        if args.profile:
            phase_profile(evaluator, roidb[1])
        del evaluator
        phase_train_reference()
        train_fwd, train_bwd = phase_train(card, work_dir, profile=args.profile)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")

    print(card)
    print(json.dumps({"kernels": [
        {
            "name": "roi_align_fwd",
            "route": "cuda",
            "source": "cim_tpu_torch/csrc/roi_align_fwd.cu",
            "replaces": "cim_tpu/ops/pallas/roi_align_kernel.py:151",
            "launches": train_fwd,
            "launches_by_path": {"eval": eval_launches, "train": train_fwd},
            **fwd_kernel,
        },
        {
            "name": "roi_align_bwd",
            "route": "cuda",
            "source": "cim_tpu_torch/csrc/roi_align_bwd.cu",
            "replaces": "cim_tpu/ops/pallas/roi_align_kernel.py:169",
            "launches": train_bwd,
            "launches_by_path": {"eval": 0, "train": train_bwd},
            **bwd_kernel,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
