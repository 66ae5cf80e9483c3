#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cim_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of the repository

It needs a CUDA device and nvcc; without a device it exits non-zero and
prints no result. It imports no JAX. Phases, each of which fails the run:

  build      compile csrc/roi_align_fwd.cu with nvcc into cim_tpu_torch/_build/
  roi_align  the kernel against its plain PyTorch version on the card, at the
             eval path's shapes (float32 and bf16) and at strides 8 and 32
  reference  the full-width model in float32: the card (kernel) against the
             CPU (plain version) on one small image with two TTA passes
  main path  run_inference of the resnet50_voc config (bf16 compute, RoIAlign
             kernel with grid cap 4, EVAL_BATCH 1) at full width with seeded
             random weights over 4 synthetic 375x500 images with 2000
             proposals each: 10 TTA passes per image, NMS, COCO box eval

With --profile, one more image of the main path runs under torch.profiler
and its device time by operator and input shape is printed.

The line before the last is a JSON object with the kernels' launches,
errors and times; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from cim_tpu.config import clone_cfg, load_cfg
from cim_tpu.data import catalog
from cim_tpu.data.synthetic import write_synthetic_coco_dataset
from cim_tpu_torch.engine.test import Evaluator
from cim_tpu_torch.engine.test_engine import get_roidb_and_dataset, run_inference
from cim_tpu_torch.models.builder import build_model
from cim_tpu_torch.models.layers import FrozenBatchNorm
from cim_tpu_torch.ops import _build
from cim_tpu_torch.ops.roi_align import roi_align, roi_align_plain

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
N_IMAGES = 4
IMAGE_HW = (375, 500)
N_PROPS = 2000
# the 1200 pass of a 375x500 image: a 960x1216 canvas, 900x1200 content
EVAL_FEAT = (60, 76, 1024)
EVAL_VALID = (57, 75)
F32_ATOL = 1e-5  # kernel vs plain in float32: sums in another order only
BF16_REL = 1e-2  # bf16: one output rounding, relative to max |features|


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


# ------------------------------------------------------------------ phases

def phase_build():
    t0 = time.perf_counter()
    path = _build.build("roi_align_fwd")
    log(f"[build] {os.path.relpath(path, REPO)} built in {time.perf_counter() - t0:.2f} s")


def _roi_case(rng, feat_hw_c, valid, scale, n, dtype):
    """Features with a zeroed pad (as the backbone leaves them) and n seeded
    rois across the valid canvas, the last 48 zero-area padding rows."""
    h, w, c = feat_hw_c
    feat = torch.zeros((h, w, c), device="cuda")
    feat[: valid[0], : valid[1]] = torch.from_numpy(
        rng.randn(valid[0], valid[1], c).astype(np.float32)).cuda()
    img_h, img_w = valid[0] / scale, valid[1] / scale
    x1 = rng.uniform(0, img_w * 0.9, n)
    y1 = rng.uniform(0, img_h * 0.9, n)
    x2 = np.minimum(x1 + rng.uniform(8, img_w * 0.6, n), img_w - 1)
    y2 = np.minimum(y1 + rng.uniform(8, img_h * 0.6, n), img_h - 1)
    rois = np.stack([x1, y1, x2, y2], -1).astype(np.float32)
    rois[-48:] = 0.0
    return feat.to(dtype).contiguous(), torch.from_numpy(rois).cuda()


def phase_roi_align():
    """Kernel vs plain version on the same inputs; returns the eval-shape
    bf16 case (the main path's) for the kernels line."""
    rng = np.random.RandomState(SEED)
    cases = [
        # (name, features, valid, scale, N, dtype, sampling_ratio, cap)
        ("eval_f32", EVAL_FEAT, EVAL_VALID, 1 / 16, 2048, torch.float32, 0, 4),
        ("eval_bf16", EVAL_FEAT, EVAL_VALID, 1 / 16, 2048, torch.bfloat16, 0, 4),
        ("eval_bf16_sr2", EVAL_FEAT, EVAL_VALID, 1 / 16, 2048, torch.bfloat16, 2, 4),
        ("eval_bf16_n2047", EVAL_FEAT, EVAL_VALID, 1 / 16, 2047, torch.bfloat16, 0, 4),
        ("eval_f32_n2047_cap2", EVAL_FEAT, EVAL_VALID, 1 / 16, 2047, torch.float32, 0, 2),
        ("stride8_bf16", (120, 152, 512), (113, 150), 1 / 8, 2048, torch.bfloat16, 0, 4),
        ("stride32_bf16", (30, 38, 2048), (29, 38), 1 / 32, 2048, torch.bfloat16, 0, 4),
    ]
    main_case = None
    with torch.no_grad():
        for name, shape, valid, scale, n, dtype, sr, cap in cases:
            feat, rois = _roi_case(rng, shape, valid, scale, n, dtype)
            args = (feat, rois, 7, scale, sr, cap, valid)
            out = roi_align(*args)
            torch.cuda.synchronize()
            ref = roi_align_plain(*args)
            check(out.shape == ref.shape == (n, 7, 7, shape[2]) and out.dtype == dtype,
                  f"{name}: output shape and dtype")
            err = (out.float() - ref.float()).abs().max().item()
            fmax = feat.float().abs().max().item()
            bound = F32_ATOL if dtype == torch.float32 else BF16_REL * fmax
            k_ms = cuda_ms(lambda: roi_align(*args), 20)
            p_ms = cuda_ms(lambda: roi_align_plain(*args), 5)
            log(f"[roi_align] {name}: features {shape} valid {valid} scale 1/{round(1 / scale)} "
                f"N {n} {str(dtype)[6:]} sampling_ratio {sr} cap {cap}: max_abs_err {err:.3g} "
                f"(bound {bound:.3g}), kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms")
            check(err <= bound, f"{name}: kernel agrees with the plain version")
            if name == "eval_bf16":
                main_case = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms}
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
        scores[device], _ = Evaluator(cfg, m).im_detect_all(im, boxes, masks)
        del m
    err = np.abs(scores["cuda"] - scores["cpu"]).max()
    log(f"[reference] float32 full-width model, 2 TTA passes, 64 proposals: "
        f"card vs CPU max_abs_err {err:.3g} (scores up to {scores['cpu'].max():.3g})")
    np.testing.assert_allclose(scores["cuda"], scores["cpu"], rtol=2e-3, atol=2e-5)


class _TimedEvaluator(Evaluator):
    """Evaluator that records each image's TTA time (host clock around
    work that ends in a device-to-host copy and a synchronize)."""

    def __init__(self, cfg, model):
        super().__init__(cfg, model)
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
    log(events.table(sort_by="self_device_time_total", row_limit=30, max_name_column_width=70))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile one image of the main path")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {card}")

    phase_build()
    kernel = phase_roi_align()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work_dir:
        launches, evaluator, roidb = phase_main_path(work_dir, card)
        if args.profile:
            phase_profile(evaluator, roidb[1])

    print(json.dumps({"kernels": [{
        "name": "roi_align_fwd",
        "route": "cuda",
        "source": "cim_tpu_torch/csrc/roi_align_fwd.cu",
        "replaces": "cim_tpu/ops/pallas/roi_align_kernel.py:151",
        "launches": launches,
        **kernel,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
