#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cim_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of the repository

It needs a CUDA device and nvcc; without a device it exits non-zero and
prints no result. It imports no JAX and nothing of cim_tpu. Phases, each
of which fails the run:

  build            compile csrc/roi_align_fwd.cu, csrc/roi_align_bwd.cu and
                   csrc/nms_from_iou.cu with nvcc into cim_tpu_torch/_build/,
                   all at once
  nms              the greedy-NMS kernel against the plain round loop on the
                   card at mining's shapes (20 classes at K 205, 256 and
                   410, 80 at 256; mining's three thresholds), twice to the
                   same bits; both timed alone at K 256 and 20 classes
  roi_align        the forward kernel against its plain PyTorch version on
                   the card, at the eval path's shapes (the maps of all five
                   TTA scales, float32 and bf16, grid caps 4 and 2), at the
                   square image's 76x76 map, at the train path's buckets
                   (scales 480, 576, 688, 864 and 1200, N 2048, and 1200
                   at N 4096), at strides 8
                   and 32, and at the VGG-16 and HRNet-W48 paths' maps
                   (stride 8: a square image's 152x152x512 1200 pass and
                   the train buckets; stride 32: 30x38x2048 and
                   12x16x2048); each
                   twice, to the same bits, with its plan, and the kernel's
                   time summed over an eval image's 10 passes; then the
                   batched forward (one launch for a stack of images, each
                   with its own valid extent): 8 bf16 images and 3 f32 at
                   the 1200 pass's map, and stacks of 8 bf16 at the VGG-16
                   (120x152x512) and HRNet-W48 (30x38x2048) 1200 pass maps,
                   against the plain version, twice to the same bits, and
                   each image bit-equal to its own call
  roi_align_bwd    the backward kernel against its plain version on the
                   card, at the train path's shapes (scales 480 and 1200,
                   N 2048 / 2047 / 4096 with zero-area padding ROIs, and
                   the buckets of scales 576, 688 and 864,
                   float32 and bf16, grid caps 4 and 2), at stride 8
                   (30 row bands, a part-filled channel slice) and at the
                   VGG-16 and HRNet-W48 train buckets (stride 32: two
                   channel slices, N 2048 and 4096); each twice, to the
                   same bits
  reference        the full-width model in float32: the card (kernels)
                   against the CPU (plain versions) on one small image with
                   two TTA passes
  eval main path   run_inference of the resnet50_voc config (bf16 compute,
                   RoIAlign grid cap 4, EVAL_BATCH 1) at full width with
                   seeded random weights over 4 synthetic 375x500 images
                   with 2000 proposals each: 10 TTA passes per image, NMS,
                   COCO box eval
  eval_batched     the float32 model's BatchedEvaluator against its
                   Evaluator on the card (two images of two sizes in one
                   stack); then run_inference at the shipped EVAL_BATCH 8
                   over 16 synthetic 375x500 images (two stacks, 20
                   forward launches), and at EVAL_BATCH 1 over the same
                   images, s/image of both
  eval_paths       every other eval configuration cim_tpu evaluates, at
                   full width over eval_batched's images (RoIAlign forward
                   launches counted from 0 around each path): (1) the
                   per-pass path (TPU.FUSED_TTA off; cv2 host resizes)
                   against the fused one, float32, 2 images x 10 passes
                   (cim_tpu's bound: rtol 5e-3, atol 5e-4, correlation >
                   0.9999); (2) one float32 pass, card vs CPU (rtol 2e-3,
                   atol 2e-5); (3) the non-fused batched path (stacks of 8
                   single passes) against per-pass in float32 over 8 images
                   (cim_tpu's rtol 1e-5, atol 1e-7), then bf16 s/image of
                   per-pass, non-fused and fused on the same images; (4)
                   UNION/UNION and UNION with an aspect-ratio pass (0.75)
                   and its hflip: (M * N, C) and (M * N, 4), each block
                   within rtol 1e-6 of its pass's own call (cuDNN
                   deterministic), NMS finite; (5) roi_pool at the 1200
                   pass's map bit-equal to the CPU, its time, one RoIPoolF
                   eval image and one RoIPoolF Trainer.step (finite losses,
                   Conv_Body moved, no RoIAlign launch); (6) the int8 head:
                   int8_conv_nhwc and int8_dense at MaskFuse's shapes, the
                   int32 sums of the first 256 rows bit-equal to the CPU's
                   and outputs within 1 ulp, one-call times beside the
                   bf16 conv and addmm with bounds, and TPU.EVAL_INT8 at
                   EVAL_BATCH 8 over 16 images beside bf16 (scores within
                   cim_tpu's max 0.05, mean 0.005; s/image, peak memory)
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
                   4096; mining one graph capture a proposal bucket and a
                   replay each other microbatch, the graphs' pool and
                   static inputs and the memory reserved across each
                   capture; then a checkpoint save / load / one more step
                   against the uninterrupted trainer
  horizon          the port's training tools through their main(argv), at
                   full width (bf16, RoIAlign cap 4, GRAD_ACCUM 4):
                   stability_run (40 steps on a pool of 2 batches of 384x512
                   with 2000 proposals: finite losses, total_loss falling);
                   long_horizon_run (24 steps in two fresh-process segments
                   of the training CLI, the second resumed from the first's
                   checkpoint, across the LR decay at step 16: iterations
                   stitched, the LR ratio SOLVER.GAMMA, warm-up, finite
                   losses, each segment's peak device memory within 1.1x of
                   the first's, one forward and one backward launch a
                   microbatch; each segment's peak memory and host RSS);
                   bench_train (s/step, images/s and MFU at the five
                   TRAIN.SCALES buckets and the 4096 run, the protocol
                   rate); profile_step; bench_eval (seq and batched over 8
                   images) and bench_host_eval
  train_cli        the training CLI (cim_tpu_torch.tools.train main()) at
                   full width on an on-disk set of 8 375x500 JPEGs with
                   2000 proposals read by TrainLoader (their full-size
                   masks also written as COB .mat files): 6 steps at
                   iter_size 4, snapshots every 3; then a run resumed from
                   the step-3 snapshot against steps 4-6 of the first
  ddp              data parallelism on the one card (parallel.launch, the
                   Trainer's DistributedDataParallel wrapper): (1) two gloo
                   ranks on cuda:0 (NCCL refuses two ranks on one card),
                   the float32 full-width model, TF32 and anti-noise off,
                   cuDNN's deterministic algorithms on both sides,
                   train_reference's microbatch shape, against world-1
                   Trainers in this process: (a) the same batch on both
                   ranks, 2 steps: the ranks' parameters bit-equal, the
                   metrics within rtol 1e-5 of world 1's, each tensor's
                   momentum buffer within 1e-4 of its largest; (b) batches
                   A and B, one step: each tensor's change (its momentum
                   buffer, the step's change before rounding into the
                   parameter) within 1e-4 of its largest of the mean of
                   world-1 runs on A and on B; one forward and one
                   backward launch a microbatch in each rank; then the
                   bf16 model on both ranks, scale-480 batches of 2000
                   proposals, 2 warm and 2 timed steps: s/step and peak
                   memory of each rank (beside a step with the gradients
                   set to None, not zeroed in DDP's buckets), two ranks
                   sharing one card (not multi-GPU speed); (2) the training CLI under torchrun's
                   environment (RANK 0, WORLD_SIZE 1: DDP over NCCL) for
                   the train_cli phase's 6 steps on its set: metrics within
                   1e-5 relative of that phase's, the snapshot's keys bare
                   and loaded by a world-1 Trainer, s/step beside
                   train_cli's; (3) BatchedEvaluator over devices [cuda:0,
                   cuda:0] against one device on eval_batched's float32
                   two-image stack (rtol 2e-3, atol 2e-5), one forward
                   launch a sub-stack and pass
  eval_cli         the eval CLIs' main() in turn, from the train CLI's
                   step-6 snapshot over the same 8 images: test_net at the
                   shipped EVAL_BATCH 8 (one stack: 10 forward launches,
                   no backward; the model equal to the checkpoint's;
                   detections.pkl and box AP), again with --corloc (VOC
                   devkit, discovery.pkl and CorLoc); evaluation with
                   --cob_dir and 2 workers (instance-seg mAP, every result
                   a proposal's .mat mask); the Mask R-CNN pseudo-label
                   export with --cob_dir from discovery.pkl (every
                   annotation a proposal's .mat mask), change_mask_thr at
                   0.3 and visualize_results on 2 images; the CLIs' times
                   (45-55 s of the whole run's 210-250 s of command time
                   on an H100, the .mat files' 36-45 s write in train_cli)
  vgg16, hrnet48   the paper's other two bodies (configs/vgg16_voc.yaml,
                   hrnet48_voc.yaml) at full width, bf16 compute, RoIAlign
                   cap 4, seeded random weights: the float32 model on the
                   card against the CPU (scores, and the body's features
                   within 1e-3 of their largest magnitude); run_inference
                   at EVAL_BATCH 8 over the eval_batched phase's 16 images
                   (20 forward launches); the float32 train microbatch on
                   the card against the CPU (losses; the gradients of
                   Box_Head and the body's last layers); the Trainer runs of
                   the train phase (4 backward launches a step, frozen
                   stages unchanged, everything else moved)
  preprocess       the offline preprocessing on the train_cli phase's
                   on-disk set (8 JPEGs, 2000 full-size COB .mat masks
                   each): generate_7_7 with 2 spawn workers (its pkl equal
                   to the host function's); create_cob_iou on the card at
                   full size (2000 x 187,500; its float16 matrices bit-equal
                   to a --device cpu run on 2 images; s/image split into
                   .mat load and the product's CUDA-event time, peak
                   memory); the float32 PRM (seeded, BN statistics
                   randomized) on the card against the CPU on one 448x448
                   image (the CRM within 1e-4 of its max, find_peaks of the
                   CPU's CRM equal, the response maps of 8 of the CPU's
                   peaks within 1e-3 relative L1; peak-set agreement on its
                   own line); 64 peaks' maps in one pass (peak memory under
                   20 GB, time); AGPL_label_assign on the card from a
                   reference-named checkpoint, at a threshold giving every
                   image 16 peaks or more (each proposal one cluster at
                   most, the assignment equal to the host's on the same
                   peaks; s/image split into load, PRM block and
                   assignment); point_level_label_assign on the card (equal
                   to the host's); the training CLI 2 steps at iter_size 4
                   on those outputs (8 forward and 8 backward launches,
                   train_cli_pre); PRMClassifierTrainer at full width
                   (FCResNet50, 20 classes, 16 x 448x448: a warm and 3 timed
                   steps, s/step, images/s, peak memory, the classifier
                   moving more than the features). The phase runs under
                   PyTorch's default cuDNN flag (TF32 allowed; the others
                   run with TF32 off): the PRM classes turn TF32 off for
                   their own calls

With --profile, one more training step (scale 1200, 2048 proposals) runs
under torch.profiler and its device time by operator, by span (the
cim.* spans of cim_tpu_torch/utils/trace.py) and of each of the port's
kernels is printed, and the CLI's sixth step is traced
(its device busy share); for each other body, one eval stack and one
train step are profiled the same way; one image's PRM block (the AGPL
CLI's peaks and response maps) is profiled for its device time; and
phase eval_paths profiles one per-pass image and one EVAL_INT8 stack.

Every path that mines counts the NMS kernel's launches from 0 and checks
one a refine branch and mined microbatch (the eval paths none).

The card's nvidia-smi name and power limit come on the [device] line and
again on a line of their own; the line before the last is a JSON object
with the kernels' launches, errors, times and bounds; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import socket
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from cim_tpu_torch import parallel
from cim_tpu_torch.config import clone_cfg, load_cfg
from cim_tpu_torch.data import catalog
from cim_tpu_torch.data.loader import _bucket_hw, proposal_bucket
from cim_tpu_torch.data.synthetic import (
    make_microbatch,
    make_train_batch,
    write_synthetic_coco_dataset,
    write_synthetic_train_dataset,
)
from cim_tpu_torch.data.transforms import scale_for_target
from cim_tpu_torch.engine.checkpoint import load_ckpt, save_ckpt
from cim_tpu_torch.engine.test import BatchedEvaluator, Evaluator
from cim_tpu_torch.engine.test_engine import get_roidb_and_dataset, run_inference
from cim_tpu_torch.engine.train import Trainer, losses_from_pseudo_labels, mine_pseudo_labels
from cim_tpu_torch.models.builder import build_model, frozen_paths_for, is_frozen
from cim_tpu_torch.models.layers import FrozenBatchNorm, torch_default_init_
from cim_tpu_torch.ops import _build
from cim_tpu_torch.ops import roi_align as ra
from cim_tpu_torch.ops.mask_iou import mask_iou_matrices
from cim_tpu_torch.ops.nms import greedy_nms_from_iou, greedy_nms_rounds
from cim_tpu_torch.ops.roi_align import (
    roi_align,
    roi_align_backward,
    roi_align_backward_plain,
    roi_align_plain,
)
from cim_tpu_torch.evaluation import rle as rle_util
from cim_tpu_torch.prm.model import MAX_PEAKS, PeakResponseMapper, load_prm_checkpoint
from cim_tpu_torch.prm.modules import find_peaks
from cim_tpu_torch.prm.train import PRMClassifierTrainer
from cim_tpu_torch.tools import bench_eval, bench_host_eval, bench_train, change_mask_thr
from cim_tpu_torch.tools import evaluation as eval_cli
from cim_tpu_torch.tools import long_horizon_run, profile_step, stability_run
from cim_tpu_torch.tools import generate_mask_for_MaskRCNN as export_cli
from cim_tpu_torch.tools import test_net as test_net_cli
from cim_tpu_torch.tools import train as train_cli
from cim_tpu_torch.tools import visualize_results
from cim_tpu_torch.tools.pre import AGPL_label_assign as agpl_cli
from cim_tpu_torch.tools.pre import create_cob_iou as iou_cli
from cim_tpu_torch.tools.pre import generate_7_7
from cim_tpu_torch.tools.pre import point_level_label_assign as points_cli

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
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}
# the stride-16 maps of the train protocol's buckets (TRAIN.SCALES of a
# 375x500 image, padded to 64: bench_train.bucket_for_scale), whole maps valid
TRAIN_MAPS = {480: (24, 32, 1024), 576: (28, 36, 1024), 688: (36, 44, 1024),
              864: (44, 56, 1024), 1200: (60, 76, 1024)}
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
    # the VGG-16 paths' (stride 8): a square image's 1200 pass, the widest
    # valid map of its eval (22,500 cells), and the train buckets
    ("vgg16_square1200_bf16", (152, 152, 512), (150, 150), 1 / 8, 2048, torch.bfloat16, 0, 4),
    ("vgg16_train1200_bf16", (120, 152, 512), (120, 152), 1 / 8, 2048, torch.bfloat16, 0, 4),
    ("vgg16_train480_bf16", (48, 64, 512), (48, 64), 1 / 8, 2048, torch.bfloat16, 0, 4),
    # the HRNet-W48 paths' (stride 32, whole maps)
    ("hrnet48_train1200_bf16", (30, 38, 2048), (30, 38), 1 / 32, 2048, torch.bfloat16, 0, 4),
    ("hrnet48_train480_bf16", (12, 16, 2048), (12, 16), 1 / 32, 2048, torch.bfloat16, 0, 4),
    # the train protocol's other three buckets (scales 576, 688 and 864 of a
    # 375x500 image: 448x576, 576x704 and 704x896), whole maps, as phase
    # horizon's bench_train runs them
    *((f"train{t}_bf16", TRAIN_MAPS[t], TRAIN_MAPS[t][:2], 1 / 16, 2048, torch.bfloat16, 0, 4)
      for t in (576, 688, 864)),
]
# the batched forward's cases (cross-image eval stacks at the 1200 pass's
# map): the images of a stack share a bucket, not a size, so each has its
# own valid extent: (name, features, scale, extents, dtype). ResNet-50's
# 60x76x1024 map, VGG-16's 120x152x512 (floor(v / 8) of the content) and
# HRNet-W48's 30x38x2048 (the whole map: HRNet masks no feature pad)
ROI_ALIGN_BATCHED_CASES = [
    ("eval_b8_bf16", EVAL_FEAT, 1 / 16, [(57, 75), (57, 68), (52, 75), (57, 75), (48, 75),
                                         (57, 60), (55, 73), (57, 75)], torch.bfloat16),
    ("eval_b3_f32", EVAL_FEAT, 1 / 16, [(57, 75), (50, 70), (57, 64)], torch.float32),
    ("vgg16_b8_bf16", (120, 152, 512), 1 / 8, [(112, 150), (112, 136), (104, 150), (112, 150),
                                               (96, 150), (112, 120), (110, 146), (112, 150)],
     torch.bfloat16),
    ("hrnet48_b8_bf16", (30, 38, 2048), 1 / 32, [(30, 38)] * 8, torch.bfloat16),
]
EVAL_BATCH = 8  # the shipped configs' TPU.EVAL_BATCH
N_BATCHED_IMAGES = 16  # two full stacks
CLI_IMAGES = 8  # the on-disk training set of the train-CLI phase
CLI_STEPS = 6
CLI_SNAPSHOT = 3  # the step of the snapshot the resumed run starts from
TRAIN_STEPS = 3  # timed steps per 2048-proposal bucket
TRAIN_SCALES = (480, 1200)
TRAIN_N_VALID = (2000, 4000)  # a typical COB count (bucket 2048), and bench.py's cap run (4096)
MIN_PEAKS = 16  # peaks each image selects in the AGPL run (its threshold is chosen for it)
PRM_CPU_PEAKS = 8  # peaks of the card-vs-CPU response-map check (8 copies at 448 on the CPU)
PRM_BATCH = 16  # the PRM classifier's training batch at 448x448
PRM_STEPS = 3
PRM_MEMORY_CAP_GB = 20.0  # one pass of MAX_PEAKS image copies must stay under it
DDP_TIMED_STEPS = 2  # the two-rank run's timed steps, after two warm ones
DDP_CLI_STEPS = CLI_STEPS  # the CLI's steps at world size 1 over NCCL, against train_cli's
# phase horizon: the stability run's steps (its loss must fall over them), and
# the segmented run's (cim_tpu's tests/test_long_horizon_cpu.py structure)
STABILITY_STEPS = 40
HORIZON = dict(total_steps=24, segment_steps=12, decay_at=16, warmup=4, disp=4)
HORIZON_PEAK_RATIO = 1.1  # a segment's peak device memory against the first's
# phase eval_paths: the per-pass / fused pair's images; the card-vs-CPU
# pass's proposals and the int8 products' rows the CPU recomputes (the
# CPU's cost); cim_tpu's bounds for the pairs it holds
PER_PASS_IMAGES = 2
CPU_PER_PASS_PROPS = 512
CPU_ROWS = 256
FUSED_TOL = dict(rtol=5e-3, atol=5e-4)  # tests/test_batched_eval.py:90
BATCHED_TOL = dict(rtol=1e-5, atol=1e-7)  # tests/test_batched_eval.py:67
INT8_MAX_DEV, INT8_MEAN_DEV = 0.05, 0.005  # tests/test_int8_eval.py:106-107


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    """Fail the run (unlike assert, kept under python -O)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    return bench_train.card_line(torch.device("cuda", torch.cuda.current_device()))


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


def graph_ms(fn, n: int = 20) -> float:
    """Device ms of one fn() call with no host time around it: n calls
    captured in one CUDA graph, its replay timed by cuda_ms, over n."""
    fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_ms(graph.replay, 10) / n


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
    names = ("roi_align_fwd", "roi_align_bwd", "nms_from_iou")
    with ThreadPoolExecutor(len(names)) as pool:
        paths = list(pool.map(_build.build, names))
    log(f"[build] {[os.path.relpath(p, REPO) for p in paths]} built in "
        f"{time.perf_counter() - t0:.2f} s")


def _nms_case(gen, classes, k):
    """Seeds of mining's shape: a symmetric IoU matrix quantized to 0.05
    (ties at the thresholds), scores sorted descending as the seeds are, the
    last eighth invalid (fewer valid proposals than the seed count)."""
    iou = torch.rand((classes, k, k), generator=gen, device="cuda")
    iou = torch.round((iou + iou.transpose(1, 2)) * 10) / 20
    scores = torch.rand((classes, k), generator=gen, device="cuda").sort(-1, descending=True)[0]
    valid = (torch.arange(k, device="cuda") < k - k // 8).expand(classes, k).contiguous()
    return iou, scores, valid


def phase_nms():
    """The NMS kernel against greedy_nms_rounds on the card, each case
    twice to the same bits; returns the kernel's and the plain loop's ms
    alone at K 256 and 20 classes (mining's seeds at the 2560 bucket)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    timed = {}
    for classes, k in ((20, 205), (20, 256), (20, 410), (80, 256)):
        iou, scores, valid = _nms_case(gen, classes, k)
        for thresh in (0.25, 0.35, 0.45000000000000007):
            got = greedy_nms_from_iou(iou, scores, thresh, valid)
            check(torch.equal(got, greedy_nms_from_iou(iou, scores, thresh, valid)),
                  f"nms {classes}x{k}: the same bits twice")
            want = greedy_nms_rounds(iou, scores, thresh, valid)
            check(torch.equal(got, want), f"nms {classes}x{k} at {thresh}: kernel == plain loop")
        if (classes, k) == (20, 256):
            kernel = lambda: greedy_nms_from_iou(iou, scores, 0.35, valid)  # noqa: E731
            timed = {"card_ms": graph_ms(kernel), "call_ms": cuda_ms(kernel, 50),
                     "plain_ms": cuda_ms(lambda: greedy_nms_rounds(iou, scores, 0.35, valid), 20),
                     "kept": int(got.sum())}
    log(f"[nms] kernel == plain loop at 20x205, 20x256, 20x410, 80x256, three thresholds; "
        f"20 classes x K 256: kernel {timed['card_ms']:.4f} ms on the device "
        f"({timed['call_ms']:.4f} ms a call with its wrapper), plain loop (host tests "
        f"included) {timed['plain_ms']:.4f} ms, {timed['kept']} kept")
    return timed


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
    main_case, times, other_shapes = None, {}, {}
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
            if name.startswith(("stride", "vgg16", "hrnet48", "train")):
                other_shapes[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                                      "bound_by": b_by, "max_abs_err": err}
            del feat, rois, out, again, ref
    passes = {t: times[f"eval{t}_bf16" if t != 1200 else "eval_bf16"] for t in EVAL_PASS_MAPS}
    main_case["eval_image_ms"] = 2 * sum(passes.values())
    log(f"[roi_align] per eval image (10 passes: each scale with and without hflip, "
        f"bf16, N 2048, cap 4): {main_case['eval_image_ms']:.4f} ms of kernel time "
        f"({', '.join(f'{t}: 2 x {ms:.4f}' for t, ms in passes.items())})")
    batched = phase_roi_align_batched(rng)
    main_case["batched"] = batched.pop("eval_b8_bf16")
    # the VGG-16 and HRNet-W48 paths' shapes, one call and batched, and the
    # train buckets'
    main_case["other_shapes"] = {**other_shapes, **batched}
    return main_case


def phase_roi_align_batched(rng):
    """The batched forward (one launch for a stack of images, each with its
    own valid extent) against its plain version, twice to the same bits,
    and each image bit-equal to a call of its own; timed beside the sum of
    those single calls. Returns the bf16 stacks of 8 (the eval paths') by
    name for the kernels line."""
    n, cap = 2048, 4
    out_cases = {}
    with torch.no_grad():
        for name, shape, scale, extents, dtype in ROI_ALIGN_BATCHED_CASES:
            cases = [_roi_case(rng, shape, hw, scale, n, dtype) for hw in extents]
            feat = torch.stack([f for f, _ in cases]).contiguous()
            rois = torch.stack([r for _, r in cases]).contiguous()
            args = (feat, rois, 7, scale, 0, cap, extents)
            batch = len(extents)
            before = roi_align.kernel_launches
            out = roi_align(*args)
            again = roi_align(*args)
            check(roi_align.kernel_launches == before + 2, f"{name}: one launch a call")
            single = [roi_align(feat[b], rois[b], 7, scale, 0, cap, hw)
                      for b, hw in enumerate(extents)]
            torch.cuda.synchronize()
            ref = roi_align_plain(*args)
            check(out.shape == ref.shape == (batch, n, 7, 7, shape[2]) and out.dtype == dtype,
                  f"{name}: output shape and dtype")
            check(torch.equal(out, again), f"{name}: two runs give the same bits")
            for b in range(batch):
                check(torch.equal(out[b], single[b]),
                      f"{name}: image {b} has the bits of a call of its own")
            err = (out.float() - ref.float()).abs().max().item()
            tol = F32_ATOL if dtype == torch.float32 else BF16_REL * feat.float().abs().max().item()
            k_ms = cuda_ms(lambda: roi_align(*args), 20)
            singles_ms = sum(cuda_ms(lambda b=b: roi_align(feat[b], rois[b], 7, scale, 0, cap,
                                                           extents[b]), 20)
                             for b in range(batch))
            p_ms = cuda_ms(lambda: roi_align_plain(*args), 2)
            cells = sum(tap_cells(rois[b], shape[1], hw, scale, 0, cap)
                        for b, hw in enumerate(extents))
            n_bytes = sum(vh * vw for vh, vw in extents) * shape[2] * feat.element_size() \
                + rois.numel() * 4 + out.numel() * out.element_size()
            b_ms, b_by = bound(n_bytes, 2.0 * shape[2] * cells, dtype)
            plan = ra.fwd_launch_plan(*max(extents, key=lambda hw: hw[0] * hw[1]), shape[2],
                                      dtype, rois.device, batch)
            log(f"[roi_align] {name}: {batch} images of {shape} valid {extents} "
                f"scale 1/{round(1 / scale)} N {n} "
                f"{str(dtype)[6:]} cap {cap}, plan {plan._asdict()}: max_abs_err {err:.3g} "
                f"(bound {tol:.3g}), two runs the same bits, each image the bits of its own call, "
                f"kernel {k_ms:.4f} ms (its {batch} single calls {singles_ms:.4f} ms), "
                f"plain {p_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by} ({cells} tap cells, "
                f"{n_bytes / 1e6:.1f} MB)")
            check(err <= tol, f"{name}: kernel agrees with the plain version")
            if dtype == torch.bfloat16:
                out_cases[name] = {"name": name, "batch": batch, "max_abs_err": err, "ms": k_ms,
                                   "single_calls_ms": singles_ms, "plain_ms": p_ms,
                                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                                   "plan": plan._asdict()}
            del feat, rois, out, again, ref, single
    return out_cases


def phase_roi_align_bwd():
    """Backward kernel vs plain version: the gradient of features
    (H, W, 1024) through N ROIs of which the last 48 are zero-area padding
    with zero gradient (as the losses leave them). The train main path's
    shapes come first: a 375x500 image at scale 1200 (target over the
    long side: a 960x1216 bucket, 60x76 features) and 480 (384x512, 24x32),
    N 2048 and the 4096 cap. Then zero-padded buckets with a smaller valid
    extent, float32, N 2047 and grid cap 2, and the stride-8 map of the
    1200 pass (120x152x512: 30 row bands of the kernel's plan, half a
    channel slice). Then the other bodies' train buckets: VGG-16's at
    stride 8 (120x152x512 and 48x64x512) and HRNet-W48's at stride 32
    (30x38x2048 with N 2048 and 4096, 12x16x2048: two channel slices).
    Each case runs twice and must give the same bits: the kernel sums in a
    fixed order. Returns the scale-1200 bf16 N 2048 case (ResNet-50's train
    main path) for the kernels line, with the other bodies' cases."""
    rng = np.random.RandomState(SEED + 3)
    t1200, t480 = ((60, 76, 1024), (60, 76)), ((24, 32, 1024), (24, 32))
    p1200, p480 = ((76, 100, 1024), (75, 100)), ((32, 40, 1024), (30, 40))
    s8 = ((120, 152, 512), (113, 150))
    # the other bodies' train buckets (whole maps)
    s8_1200, s8_480 = ((120, 152, 512), (120, 152)), ((48, 64, 512), (48, 64))
    s32_1200, s32_480 = ((30, 38, 2048), (30, 38)), ((12, 16, 2048), (12, 16))
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
        ("vgg16_train1200_bf16", s8_1200, 1 / 8, 2048, bf16, 4),
        ("vgg16_train480_bf16", s8_480, 1 / 8, 2048, bf16, 4),
        ("hrnet48_train1200_bf16", s32_1200, 1 / 32, 2048, bf16, 4),
        ("hrnet48_train1200_bf16_n4096", s32_1200, 1 / 32, 4096, bf16, 4),
        ("hrnet48_train480_bf16", s32_480, 1 / 32, 2048, bf16, 4),
        # the train protocol's other three buckets (scales 576, 688, 864)
        *((f"train{t}_bf16", (TRAIN_MAPS[t], TRAIN_MAPS[t][:2]), 1 / 16, 2048, bf16, 4)
          for t in (576, 688, 864)),
    ]
    main_case, other_shapes = None, {}
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
        if name.startswith(("stride8", "vgg16", "hrnet48", "train")):
            other_shapes[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                                  "bound_by": b_by, "max_abs_err": err}
        del out, again, ref, mag, g
    main_case["other_shapes"] = other_shapes
    return main_case


def _smoke_cfg(data_dir, props, config="resnet50_voc"):
    cfg = load_cfg(os.path.join(REPO, "configs", f"{config}.yaml"))
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


def phase_reference(cfg, model, tag="reference"):
    """The full-width model in float32, TF32 off: the card (RoIAlign kernel)
    against the CPU (plain version), one 120x160 image, hflip + identity:
    scores within rtol 2e-3, atol 2e-5, and the body's features of a
    128x160 image within 1e-3 of their largest magnitude (float32 sums in
    another order, cuDNN's against the CPU's, through up to ~100 convs)."""
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
    feat_in = torch.from_numpy(rng.randn(128, 160, 3).astype(np.float32) * 50)
    scores, feats = {}, {}
    for device in ("cuda", "cpu"):
        m = build_model(cfg, device=device)
        m.load_state_dict(state)
        scores[device], _ = Evaluator(cfg, m, device=device).im_detect_all(im, boxes, masks)
        with torch.no_grad():
            feats[device] = m.convbody_net(feat_in.to(device)).cpu()
        del m
    err = np.abs(scores["cuda"] - scores["cpu"]).max()
    fmax = feats["cpu"].abs().max().item()
    ferr = (feats["cuda"] - feats["cpu"]).abs().max().item()
    log(f"[{tag}] float32 full-width model, 2 TTA passes, 64 proposals: "
        f"card vs CPU max_abs_err {err:.3g} (scores up to {scores['cpu'].max():.3g}); "
        f"features {tuple(feats['cpu'].shape)} max_abs_err {ferr:.3g} of max |feature| "
        f"{fmax:.3g} ({ferr / fmax:.3g}), {100 * (feats['cpu'] == 0).float().mean().item():.1f} % "
        f"zero, std over cells / max {feats['cpu'].reshape(-1, feats['cpu'].shape[-1]).std(0).mean().item() / fmax:.3g}")
    check(torch.isfinite(feats["cuda"]).all() and fmax > 0, f"{tag}: features finite, not all zero")
    check(ferr <= 1e-3 * fmax, f"{tag}: card features agree with the CPU's")
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
    _zero_launches()
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
    _record_nms("eval", 0)
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


class _TimedBatchedEvaluator(BatchedEvaluator):
    """BatchedEvaluator that records the time and the images of each
    im_detect_all_many call: host clock around the whole call, each image's
    preparation on the host included, as _TimedEvaluator times an image."""

    def __init__(self, cfg, model):
        super().__init__(cfg, model, device="cuda")
        self.seconds = []  # (seconds, images) a call

    def im_detect_all_many(self, items, window=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = super().im_detect_all_many(items, window)
        torch.cuda.synchronize()
        self.seconds.append((time.perf_counter() - t0, len(items)))
        return out

    def per_image(self):
        """Seconds an image over the calls recorded."""
        return sum(s for s, _ in self.seconds) / sum(n for _, n in self.seconds)


def _batched_reference_setup(cfg):
    """phase_batched_reference's float32 config (hflip + identity at scale
    160) and its stack of two images of different sizes, 64 proposals."""
    cfg = clone_cfg(cfg)
    cfg.TPU.PRECISION = "f32"
    cfg.TEST.SCALE = 160
    cfg.TEST.BBOX_AUG.SCALES = ()
    rng = np.random.RandomState(SEED + 5)
    items = []
    for h, w in ((120, 160), (112, 150)):  # one bucket (128x256), one ratio bucket (0.75)
        x1, y1 = rng.uniform(0, w - 20, 64), rng.uniform(0, h - 20, 64)
        boxes = np.stack([x1, y1, np.minimum(x1 + rng.uniform(8, 90, 64), w - 1),
                          np.minimum(y1 + rng.uniform(8, 70, 64), h - 1)], -1).astype(np.float32)
        items.append((rng.randint(0, 256, (h, w, 3)).astype(np.uint8), boxes,
                      (rng.rand(64, 7, 7) > 0.4).astype(np.float32)))
    return cfg, items


def phase_batched_reference(cfg, model):
    """The full-width model in float32, TF32 off, on the card:
    BatchedEvaluator against Evaluator on two images of different sizes in
    one stack (hflip + identity), rtol 2e-3, atol 2e-5."""
    cfg, items = _batched_reference_setup(cfg)
    m = build_model(cfg, device="cuda")
    m.load_state_dict({k: v.detach() for k, v in model.state_dict().items()})
    got = BatchedEvaluator(cfg, m, 2, device="cuda").im_detect_all_many(items)
    sequential = Evaluator(cfg, m, device="cuda")
    errs = []
    for (scores, _), item in zip(got, items):
        want, _ = sequential.im_detect_all(*item)
        errs.append(float(np.abs(scores - want).max()))
        np.testing.assert_allclose(scores, want, rtol=2e-3, atol=2e-5)
    log(f"[eval_batched] float32 full-width model, a stack of 2 images (120x160, 112x150), "
        f"2 TTA passes, 64 proposals: BatchedEvaluator vs Evaluator on the card max_abs_err "
        f"{max(errs):.3g}")
    del m


def _eval_stacks(cfg, model, roidb, out_dir, card, tag):
    """run_inference at the shipped EVAL_BATCH over the roidb's
    N_BATCHED_IMAGES images, after one warm stack outside the counted run
    (cuDNN's choices at the batch, the allocator): one forward launch a
    pass of each stack and no backward, scores finite in [0, 1] and not
    constant, a finite AP. Returns (the evaluator, the scores, the forward
    launches, the run's seconds)."""
    passes = Evaluator.tta_pass_list(cfg)
    batched = _TimedBatchedEvaluator(cfg, model)
    batched.im_detect_all_many([(_image_loader(e), e["boxes"], e["masks"])
                                for e in roidb[:EVAL_BATCH]])
    warm_s = batched.seconds.pop()[0]
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    results, _, all_scores = run_inference(cfg, model, out_dir, image_loader=_image_loader,
                                           evaluator=batched)
    e2e_s = time.perf_counter() - t0
    launches = roi_align.kernel_launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stacks = N_BATCHED_IMAGES // EVAL_BATCH
    check(launches == len(passes) * stacks,
          f"{tag}: {launches} roi_align kernel launches for {stacks} stacks x {len(passes)} passes")
    check(roi_align_backward.kernel_launches == 0, f"{tag}: eval launches no backward kernel")
    _record_nms(tag if tag.startswith("eval") else f"eval_{tag}", 0)
    check(len(all_scores) == N_BATCHED_IMAGES, f"{tag}: one score record per image")
    for name, rec in all_scores.items():
        s = rec["scores"]
        check(s.shape == (N_PROPS, cfg.MODEL.NUM_CLASSES), f"{tag} {name}: scores shape {s.shape}")
        check(np.isfinite(s).all() and s.min() >= 0.0 and s.max() <= 1.0,
              f"{tag} {name}: scores finite in [0, 1]")
        check(s.std() > 0, f"{tag} {name}: scores not constant")
    check(np.isfinite(results["AP"]) and np.isfinite(results["AP50"]), f"{tag}: finite COCO AP")
    log(f"[{tag}] {card}: EVAL_BATCH {EVAL_BATCH}, {N_BATCHED_IMAGES} images: fused TTA "
        f"{batched.per_image():.4f} s/image (im_detect_all_many calls "
        f"{[(round(s, 4), n) for s, n in batched.seconds]} as (s, images); "
        f"warm-up stack {warm_s:.3f} s), run_inference end to end "
        f"{e2e_s / N_BATCHED_IMAGES:.4f} s/image, peak device memory {peak_gb:.2f} GB, "
        f"roi_align kernel launches {launches}")
    return batched, all_scores, launches, e2e_s


def phase_eval_batched(work_dir, card, model, profile=False):
    """run_inference at the shipped EVAL_BATCH over N_BATCHED_IMAGES
    images (two full stacks), between two runs at EVAL_BATCH 1 over the
    same images; with ``profile``, one stack under torch.profiler. Returns
    the forward kernel's launches of the batched run, and the images'
    directory and proposal file (the other bodies' eval runs over them)."""
    data_dir = os.path.join(work_dir, "batched")
    os.makedirs(data_dir)
    ann, props = write_synthetic_coco_dataset(
        data_dir, N_BATCHED_IMAGES, N_PROPS, np.random.RandomState(SEED + 5),
        image_hw=IMAGE_HW, write_jpegs=False,
    )
    catalog.register_dataset("chip_smoke_batched", {catalog.IM_DIR: data_dir, catalog.ANN_FN: ann})
    cfg = _smoke_cfg(data_dir, props)
    cfg.TEST.DATASETS = ("chip_smoke_batched",)
    cfg.TPU.EVAL_BATCH = EVAL_BATCH
    phase_batched_reference(cfg, model)
    roidb = get_roidb_and_dataset(cfg, cfg.TEST.DATASETS[0], props)[0]

    # the same images one at a time, before and after the batched run
    cfg1 = clone_cfg(cfg)
    cfg1.TPU.EVAL_BATCH = 1
    sequential = _TimedEvaluator(cfg1, model)
    sequential.im_detect_all(_image_loader(roidb[0]), roidb[0]["boxes"], roidb[0]["masks"])
    sequential.seconds.pop()

    def run_sequential(tag):
        sequential.seconds.clear()
        t0 = time.perf_counter()
        _, _, scores = run_inference(cfg1, model, os.path.join(data_dir, "out1" + tag),
                                     image_loader=_image_loader, evaluator=sequential)
        return scores, (time.perf_counter() - t0) / N_BATCHED_IMAGES, list(sequential.seconds)

    scores_1, e2e_1, secs_1 = run_sequential("a")

    batched, all_scores, launches, e2e_s = _eval_stacks(
        cfg, model, roidb, os.path.join(data_dir, "out"), card, "eval_batched")
    per_image_b = batched.per_image()
    _, e2e_1b, secs_1b = run_sequential("b")
    diff = max(float(np.abs(all_scores[k]["scores"] - scores_1[k]["scores"]).max())
               for k in scores_1)
    # both timed over the same images and the same work: each image's
    # preparation on the host, its TTA passes, the scores' copy to the host
    log(f"[eval_batched] {card}: evaluator s/image (the evaluator's time over the "
        f"{N_BATCHED_IMAGES} images, divided by {N_BATCHED_IMAGES}), in the order run: "
        f"EVAL_BATCH 1 {np.mean(secs_1):.4f}, EVAL_BATCH {EVAL_BATCH} {per_image_b:.4f}, "
        f"EVAL_BATCH 1 {np.mean(secs_1b):.4f} (EVAL_BATCH 1's images "
        f"{[round(s, 4) for s in secs_1]} and {[round(s, 4) for s in secs_1b]}); "
        f"run_inference end to end {e2e_1:.4f}, {e2e_s / N_BATCHED_IMAGES:.4f}, "
        f"{e2e_1b:.4f} s/image; the bf16 scores of EVAL_BATCH {EVAL_BATCH} and 1 differ by "
        f"at most {diff:.3g}")
    if profile:
        phase_profile_batched(batched, roidb[:EVAL_BATCH])
    return launches, data_dir, props


# the other bodies of the paper: (config, the modules whose gradients the
# train reference holds to the CPU's: the head and the body's last layers)
BODIES = {
    "vgg16": ("vgg16_voc", ("Box_Head.", "Conv_Body.conv5.")),
    "hrnet48": ("hrnet48_voc", ("Box_Head.", "Conv_Body.final_layer.",
                                "Conv_Body.downsamp_modules.")),
}


def phase_body(body, card, data_dir, props, profile=False):
    """A body's eval and train paths at full width (bf16 compute, RoIAlign
    cap 4, seeded random weights): the float32 model on the card against
    the CPU (scores and features); run_inference at the shipped EVAL_BATCH
    over the eval_batched phase's N_BATCHED_IMAGES images after a warm
    stack; the float32 train microbatch on the card against the CPU; then
    the Trainer runs of _train_runs. Returns the kernels' launches: eval
    forward, train forward, train backward."""
    config, grads_of = BODIES[body]
    cfg = _smoke_cfg(data_dir, props, config)
    cfg.TEST.DATASETS = ("chip_smoke_batched",)
    cfg.TPU.EVAL_BATCH = EVAL_BATCH
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    model = build_model(cfg, device="cuda", generator=gen)
    _randomize_frozen_bn(model, gen)
    body_cls = model.body_cls
    log(f"[{body}] {config}: {sum(p.numel() for p in model.parameters())} params (body "
        f"{sum(p.numel() for p in model.Conv_Body.parameters())}), {body_cls.dim_out} channels "
        f"at stride {round(1 / body_cls.spatial_scale)}, set-up {time.perf_counter() - t0:.1f} s")
    phase_reference(cfg, model, tag=f"{body}_reference")

    roidb = get_roidb_and_dataset(cfg, cfg.TEST.DATASETS[0], props)[0]
    batched, _, eval_fwd, _ = _eval_stacks(cfg, model, roidb,
                                           os.path.join(data_dir, f"out_{body}"), card, body)
    if profile:
        phase_profile_batched(batched, roidb[:EVAL_BATCH], tag=f"{body}: one stack")
    del model, batched
    torch.cuda.empty_cache()

    phase_train_reference(config, grads_of, tag=f"{body}_train_reference")
    _, trainer, batches, runs, train_fwd, train_bwd = _train_runs(card, config,
                                                                  tag=f"{body}_train")
    _record_nms(f"train_{body}", train_fwd)
    if profile:
        phase_train_profile(trainer, batches[TRAIN_SCALES[-1]], runs[TRAIN_SCALES[-1]],
                            tag=f"{body}: one train step")
    del trainer
    torch.cuda.empty_cache()
    return eval_fwd, train_fwd, train_bwd


def phase_profile_batched(batched, entries, tag="one stack"):
    """Device time of one stack's TTA by operator, against the unprofiled
    run's time an image (the device's busy share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    image_ms = 1e3 * batched.per_image()
    items = [(_image_loader(e), e["boxes"], e["masks"]) for e in entries]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        batched.im_detect_all_many(items)
        torch.cuda.synchronize()
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3
    log(f"[profile] {tag} of {len(items)} images: device busy {device_ms:.1f} ms, "
        f"{device_ms / len(items):.1f} ms an image of the unprofiled run's {image_ms:.1f} ms "
        f"({100 * device_ms / len(items) / image_ms:.1f} %)")
    _log_port_kernels(events, device_ms)
    log(events.table(sort_by="self_device_time_total", row_limit=20, max_name_column_width=70))


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


def phase_profile(evaluator, entry, tag="one image"):
    """Device time of one image's TTA by operator, against the median
    unprofiled s/image of ``evaluator`` (the device's busy share)."""
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
    log(f"[profile] {tag}: device busy {device_ms:.1f} ms of the {median_ms:.1f} ms "
        f"median unprofiled image ({100 * device_ms / median_ms:.1f} %)")
    _log_port_kernels(events, device_ms)
    log(events.table(sort_by="self_device_time_total", row_limit=30, max_name_column_width=70))


# ------------------------------------------------------------- training

def _train_cfg(config="resnet50_voc"):
    cfg = load_cfg(os.path.join(REPO, "configs", f"{config}.yaml"))
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


def phase_train_reference(config="resnet50_voc", grads_of=("Box_Head.", "Conv_Body.res4."),
                          tag="train_reference"):
    """One float32 microbatch, card vs CPU, from one set of weights: every
    loss metric within rtol 1e-4 (atol 1e-6), and each gradient tensor of
    the modules ``grads_of`` (ResNet-50's: Box_Head and Conv_Body.res4)
    within 1e-2 of its CPU norm,
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
    cfg = _train_cfg(config)
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
                 if n.startswith(grads_of)}
        out[name] = ({k: v.item() for k, v in losses.items()}, grads)
    check(roi_align.kernel_launches == fwd0 + 1 and roi_align_backward.kernel_launches == bwd0 + 1,
          "the card's microbatch ran both kernels once")
    (lc, gc), (lh, gh) = out["cuda"], out["cpu"]
    log(f"[{tag}] float32 full width, 64 proposals: the card's own mining labels "
        f"{differ} rows of {len(shared)} branches differently from the CPU's; with the CPU's "
        f"pseudo labels, losses card {lc} / CPU {lh}")
    for k, v in lh.items():
        check(np.isfinite(lc[k]) and abs(lc[k] - v) <= 1e-6 + 1e-4 * abs(v),
              f"{tag}: {k} card {lc[k]} vs CPU {v}")
    worst = max(((gc[n] - gh[n]).norm().item() / max(gh[n].norm().item(), 1e-30), n) for n in gh)
    worst_el = max(((gc[n] - gh[n]).abs().max().item() / max(gh[n].abs().max().item(), 1e-30), n)
                   for n in gh)
    log(f"[{tag}] {len(gh)} gradient tensors of {', '.join(grads_of)}: "
        f"worst ||card - CPU|| / ||CPU|| {worst[0]:.3g} ({worst[1]}); worst "
        f"max|card - CPU| / max|CPU| {worst_el[0]:.3g} ({worst_el[1]})")
    check(worst[0] <= 1e-2, f"{tag}: gradient of {worst[1]} agrees")
    check(lh["has_gt_0"] == 1.0, "the reference microbatch mined a pseudo-GT")


def _timed_steps(trainer, batch, n):
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.step(batch)  # ends in a device-to-host copy of the metrics
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0, m))
    return out


def _train_runs(card, config="resnet50_voc", tag="train"):
    """Trainer of ``config`` at full width (bf16 compute, RoIAlign cap 4,
    GRAD_ACCUM 4, seeded random weights): a warm step, then TRAIN_STEPS
    timed steps at each TRAIN_SCALES bucket with 2000 proposals, then a
    warm and a timed step at scale 1200 with 4000. Checks the launches
    (one forward and one backward a microbatch), finite losses, the frozen
    stages unchanged and every other parameter moved. Returns (cfg,
    trainer, batches, runs, forward launches, backward launches)."""
    cfg = _train_cfg(config)
    accum = cfg.TPU.GRAD_ACCUM
    rng = np.random.RandomState(SEED + 4)
    t0 = time.perf_counter()
    batches = {scale: _train_batch(cfg, rng, scale, TRAIN_N_VALID[0]) for scale in TRAIN_SCALES}
    batches["4096"] = _train_batch(cfg, rng, TRAIN_SCALES[-1], TRAIN_N_VALID[1])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    trainer = Trainer(cfg, device="cuda", seed=SEED, init_generator=gen)
    _randomize_frozen_bn(trainer.model, gen)
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    log(f"[{tag}] {config}: GRAD_ACCUM {accum}, buckets "
        f"{ {k: tuple(b['image'].shape[1:3]) + (b['rois'].shape[1],) for k, b in batches.items()} }, "
        f"set-up {time.perf_counter() - t0:.1f} s")

    _zero_launches()
    graphs = trainer.mining_graphs
    runs, peak_gb, reserved_gb = {}, {}, {}
    for key, n in [*((s, TRAIN_STEPS) for s in TRAIN_SCALES), ("4096", 1)]:
        batch = batches[key]
        torch.cuda.reset_peak_memory_stats()
        captured = len(graphs)
        reserved = torch.cuda.memory_reserved()
        runs[f"warm {key}"] = _timed_steps(trainer, batch, 1)
        if len(graphs) > captured:  # the warm step captured this bucket's mining graph
            reserved_gb[key] = ((torch.cuda.memory_reserved() - reserved) / 1e9,
                                torch.cuda.max_memory_reserved() / 1e9)
        runs[key] = _timed_steps(trainer, batch, n)
        peak_gb[key] = torch.cuda.max_memory_allocated() / 1e9
    n_steps = sum(len(v) for v in runs.values())
    fwd, bwd = roi_align.kernel_launches, roi_align_backward.kernel_launches
    mining = {"captures": graphs.captures, "replays": graphs.replays,
              "eager_runs": graphs.eager_runs}
    # one mining graph a proposal bucket (2048, 4096), warmed by its first
    # microbatch; every other microbatch replays it
    check(mining == {"captures": 2, "eager_runs": 2, "replays": n_steps * accum - 2},
          f"{tag}: mining {mining} for {n_steps} steps x {accum}")
    pool, static = graphs.device_bytes()
    log(f"[{tag}] mining graphs {len(graphs)}: their shared pool holds "
        f"{'not told by the allocator' if pool is None else f'{pool / 1e9:.3f} GB'}, their "
        f"static inputs {static / 1e9:.3f} GB; device memory reserved across each capturing "
        f"warm step (grown, the step's peak reserved) GB: "
        f"{ {k: (round(a, 3), round(b, 3)) for k, (a, b) in reserved_gb.items()} }, reserved "
        f"now {torch.cuda.memory_reserved() / 1e9:.3f} GB")

    check(fwd == bwd == n_steps * accum,
          f"{tag}: {fwd} forward / {bwd} backward kernel launches for {n_steps} steps x {accum}")
    for key, steps in runs.items():
        for _, m in steps:
            check(all(np.isfinite(v) for v in m.values()), f"{tag} {key}: finite losses {m}")
    frozen = frozen_paths_for(cfg)
    for n, p in trainer.model.named_parameters():
        same = torch.equal(p.detach(), before[n])
        if n == "cls_iou_model.detector.bias":
            # the detector's softmax runs over proposals, so a per-class
            # bias cancels: its gradient is zero but for rounding, and a
            # bias has no weight decay
            continue
        check(same == is_frozen(n, frozen),
              f"{tag} {n}: {'unchanged' if same else 'moved'} (frozen: {is_frozen(n, frozen)})")
    for key in [*TRAIN_SCALES, "4096"]:
        secs = [s for s, _ in runs[key]]
        _, last = runs[key][-1]
        log(f"[{tag}] {card}: bucket {key}: s/step median {np.median(secs):.4f} "
            f"(each {[round(s, 4) for s in secs]}), {accum / np.median(secs):.2f} images/s, "
            f"peak device memory {peak_gb[key]:.2f} GB; "
            f"losses {({k: round(v, 4) for k, v in last.items() if 'loss' in k})}, "
            f"mined_gt {[round(last[f'mined_gt_{k}'], 1) for k in range(cfg.REFINE_TIMES)]}")
    log(f"[{tag}] warm-up steps s: {[round(runs[k][0][0], 3) for k in runs if 'warm' in str(k)]}; "
        f"frozen {frozen}; launches forward {fwd}, backward {bwd}; mining {mining}")
    return cfg, trainer, batches, runs, fwd, bwd


def phase_train(card, work_dir, profile=False):
    """The resnet50_voc Trainer at full width (_train_runs), then a
    checkpoint resume. Returns the forward and backward kernels' launches
    of the training runs."""
    cfg, trainer, batches, runs, fwd, bwd = _train_runs(card)
    _record_nms("train", fwd)

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


def phase_train_profile(trainer, batch, timed, tag="one train step"):
    """Device time of one training step by operator and by phase, against
    the median unprofiled s/step of its bucket."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    median_ms = 1e3 * float(np.median([s for s, _ in timed]))
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
    log(f"[profile] {tag}: device busy {device_ms:.1f} ms of the {wall_ms:.1f} ms "
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


def _launches():
    return roi_align.kernel_launches, roi_align_backward.kernel_launches


def _zero_launches():
    roi_align.kernel_launches = 0
    roi_align_backward.kernel_launches = 0
    greedy_nms_from_iou.kernel_launches = 0


NMS_LAUNCHES = {}  # path: greedy_nms_from_iou's launches, read by _record_nms


def _record_nms(path, microbatches, launches=None):
    """The NMS kernel's launches on ``path``, since _zero_launches (or
    ``launches``, those counted in other processes): one a refine branch
    and mined microbatch, whether the mining ran op by op or as a graph
    replay."""
    n = greedy_nms_from_iou.kernel_launches if launches is None else launches
    want = _train_cfg().REFINE_TIMES * microbatches
    check(n == want, f"{path}: {n} NMS kernel launches, want {want} for {microbatches} "
                     f"microbatches")
    NMS_LAUNCHES[path] = n


def phase_horizon(work_dir, card):
    """The port's training tools at full width (resnet50_voc, bf16 compute,
    RoIAlign cap 4, GRAD_ACCUM 4), through their main(argv): (a)
    stability_run, STABILITY_STEPS steps on a pool of 2 batches of 384x512
    with 2000 proposals (finite losses, total_loss falling); (b)
    long_horizon_run, two fresh-process segments of the training CLI, the
    second resumed from the first's checkpoint, across the LR decay at
    step 16 (iterations stitched, the LR ratio SOLVER.GAMMA, warm-up,
    finite losses, each segment's peak device memory within
    HORIZON_PEAK_RATIO of the first's, one forward and one backward launch
    a microbatch from the segments' run_end lines); (c) bench_train at the
    five TRAIN.SCALES buckets and the 4096 run; (d) profile_step; (e)
    bench_eval (seq and batched over 8 images) and bench_host_eval.
    Returns each tool's (forward, backward) launches by path."""
    t_phase = time.perf_counter()
    launches = {}
    # the segments are child processes on this card: hand them the cache
    torch.cuda.empty_cache()
    _zero_launches()
    st = stability_run.main(["--steps", str(STABILITY_STEPS), "--batch_pool", "2",
                             "--precision", "bf16_compute", "--seed", str(SEED)])
    launches["train_stability"] = _launches()
    accum = st["grad_accum"]
    _record_nms("train_stability", STABILITY_STEPS * accum)
    check(launches["train_stability"] == (STABILITY_STEPS * accum,) * 2,
          f"stability: launches {launches['train_stability']} for {STABILITY_STEPS} steps")
    totals = [h["total_loss"] for h in st["history"]]
    log(f"[horizon] stability_run {card}: {STABILITY_STEPS} steps of {accum} images at "
        f"{tuple(st['image_hw'])}, {st['n_props']} proposals (pad {st['proposal_pad']}), a pool "
        f"of 2: total_loss {totals[0]:.4f} -> {totals[-1]:.4f} (every 5th: "
        f"{[round(t, 4) for t in totals[::5]]}), steady s/step {st['s_per_step_steady']:.4f}, "
        f"{st['images_per_sec_steady']:.2f} images/s, first step {st['first_step_s']:.3f} s, "
        f"peak device memory {st['peak_device_gb']:.2f} GB")
    torch.cuda.empty_cache()

    out = os.path.join(work_dir, "horizon.json")
    argv = [f"--{k}={v}" for k, v in HORIZON.items()] + [
        "--synth_image", "384", "512", "--synth_props", "2048", "--synth_valid", "2000",
        "--workdir", os.path.join(work_dir, "horizon"), "--out", out,
        "--set", "TPU.PALLAS_ROI_ALIGN", "True", "TPU.PRECISION", "bf16_compute"]
    t0 = time.perf_counter()
    hz = long_horizon_run.main(argv)
    horizon_s = time.perf_counter() - t0
    segs, bounds = hz["segments_wall"], hz["segment_boundaries"]
    iters = [s["iter"] for s in hz["trajectory_every_disp"]]
    gamma = load_cfg(os.path.join(REPO, "configs", "resnet50_voc.yaml")).SOLVER.GAMMA
    check(hz["ok"] and hz["segments"] == 2 and hz["steps_completed"] == HORIZON["total_steps"],
          f"horizon: {hz['segments']} segments, {hz['steps_completed']} steps")
    check(iters == sorted(set(iters)) and [b["first_iter"] for b in bounds] == [0, 12]
          and bounds[0]["last_iter"] < 12, f"horizon: segments stitched, iterations {iters}")
    check(hz["lr_decay_ratio"] is not None and abs(hz["lr_decay_ratio"] - gamma) <= 1e-6,
          f"horizon: LR ratio {hz['lr_decay_ratio']} at the decay, SOLVER.GAMMA {gamma}")
    check(hz["trajectory_every_disp"][0]["lr"] < hz["lr_pre_decay"], "horizon: warm-up")
    check(all(np.isfinite(s["loss"]) for s in hz["trajectory_every_disp"]),
          "horizon: finite losses")
    peaks = [s["peak_device_gb"] for s in segs]
    check(all(p <= HORIZON_PEAK_RATIO * peaks[0] for p in peaks),
          f"horizon: each segment's peak device memory within {HORIZON_PEAK_RATIO}x of the "
          f"first's: {peaks}")
    launches["train_horizon"] = (sum(s["roi_align_fwd_launches"] for s in segs),
                                 sum(s["roi_align_bwd_launches"] for s in segs))
    check(launches["train_horizon"] == (HORIZON["total_steps"] * accum,) * 2,
          f"horizon: launches {launches['train_horizon']} for {HORIZON['total_steps']} steps")
    _record_nms("train_horizon", HORIZON["total_steps"] * accum,
                sum(s["nms_launches"] for s in segs))
    log(f"[horizon] long_horizon_run {card}: {HORIZON['total_steps']} steps in "
        f"{len(segs)} fresh-process segments at 384x512, 2000 proposals (pad 2048), decay at "
        f"{HORIZON['decay_at']}, warm-up {HORIZON['warmup']}: LR {hz['lr_pre_decay']:.6g} -> "
        f"{hz['lr_post_decay']:.6g} (ratio {hz['lr_decay_ratio']}), loss "
        f"{hz['first_loss']} -> {hz['final_loss']}, mining health {hz['mining_health']}, "
        f"boundaries {bounds}; {horizon_s:.1f} s")
    for s in segs:
        log(f"[horizon] segment {s['segment']} (to step {s['max_iter']}): wall {s['wall_s']} s, "
            f"peak device memory {s['peak_device_gb']} GB, peak host RSS {s['peak_rss_gb']} GB, "
            f"launches forward {s['roi_align_fwd_launches']}, backward "
            f"{s['roi_align_bwd_launches']}, NMS {s['nms_launches']}")

    _zero_launches()
    bt = bench_train.main([], log=log)
    launches["train_protocol"] = _launches()
    n_steps = sum(1 + (10 if s <= 576 else 6) for s in bt["per_scale"]) + 1 + 6  # + the 4096 run
    check(launches["train_protocol"] == (n_steps * accum,) * 2,
          f"bench_train: launches {launches['train_protocol']} for {n_steps} steps")
    _record_nms("train_protocol", n_steps * accum)
    for s, r in bt["per_scale"].items():
        log(f"[horizon] bench_train {card}: scale {s} bucket {tuple(r['bucket_hw'])}: "
            f"s/step {r['s_per_step']:.4f}, {r['images_per_sec']:.3f} images/s, MFU "
            f"{r['mfu_model']} (model) / {r['mfu_padded']} (padded)")
    r = bt["proposal_4096_at_1200"]
    log(f"[horizon] bench_train {card}: 4000 -> 4096 proposals at scale 1200: s/step "
        f"{r['s_per_step']:.4f}, {r['images_per_sec']:.3f} images/s, MFU {r['mfu_model']}, peak "
        f"device memory {r['peak_device_gb']} GB; protocol rate (harmonic mean of the five) "
        f"{bt['value']} images/s, mean MFU {bt['mfu_model_protocol']}")
    torch.cuda.empty_cache()

    _zero_launches()
    ms = profile_step.main([], log=lambda m: log(f"[horizon] profile_step: {m}"))
    launches["profile_step"] = _launches()
    # its timed forward-alone calls run as many forwards without mining as
    # its mining-alone calls mine without one; one more forward makes the
    # mining-alone calls' input
    _record_nms("profile_step", launches["profile_step"][0] - 1)
    check(all(np.isfinite(v) and v > 0 for v in ms.values()), f"profile_step: {ms}")
    torch.cuda.empty_cache()

    _zero_launches()
    ev = bench_eval.main(["--modes", "seq,batched", "--n_images", "8", "--eval_batch",
                          str(EVAL_BATCH), "--n_props", str(N_PROPS)],
                         log=lambda m: log(f"[horizon] bench_eval {card}: {m}"))
    launches["bench_eval"] = _launches()
    check(all(np.isfinite(r["value"]) and 0 < r["mfu_model"] < 1 for r in ev.values()),
          f"bench_eval: {ev}")
    host = bench_host_eval.main(["--images", "100", "--coco_images", "30"],
                                log=lambda m: log(f"[horizon] bench_host_eval: {m}"))
    check(host["kept_dets_mean"] > 0 and host["rles_mean"] > 0, f"bench_host_eval: {host}")
    log(f"[horizon] phase {time.perf_counter() - t_phase:.1f} s; RoIAlign (forward, backward) "
        f"launches by path {launches}; NMS launches by path {NMS_LAUNCHES}")
    return launches


def _iou_on_card(masks):
    """(iou, asy_iou) float32 arrays of (n, h, w) bool masks, from one
    product on the card (ops.mask_iou, exact counts)."""
    return tuple(m.cpu().numpy() for m in mask_iou_matrices(torch.from_numpy(masks).cuda()))


def phase_train_cli(work_dir, card, profile=False):
    """The training CLI (python -m cim_tpu_torch.tools.train) through its
    main(), at full width on the real data path: an on-disk set of
    CLI_IMAGES 375x500 JPEGs with N_PROPS proposals, their IoU pickles and
    label assignment, read by TrainLoader. CLI_STEPS steps at iter_size 4
    with a snapshot every CLI_SNAPSHOT steps, then a run resumed from the
    snapshot at CLI_SNAPSHOT against the uninterrupted run's steps after it
    (losses within rtol 1e-5). Returns the kernels' launches of the first
    run."""
    t0 = time.perf_counter()
    data_dir = os.path.join(work_dir, "train_cli")
    paths = write_synthetic_train_dataset(data_dir, CLI_IMAGES, N_PROPS,
                                          np.random.RandomState(SEED + 6), image_hw=IMAGE_HW,
                                          iou_fn=_iou_on_card,
                                          cob_dir=os.path.join(data_dir, "cob"))
    catalog.register_dataset("chip_smoke_train", {catalog.IM_DIR: paths["image_dir"],
                                                  catalog.ANN_FN: paths["ann"]})
    write_s = time.perf_counter() - t0
    log(f"[train_cli] on-disk set of {CLI_IMAGES} images written in {write_s:.1f} s, of which "
        f"each image's {N_PROPS} full-size masks as a compressed COB .mat "
        f"{np.mean(paths['cob_write_s']):.3f} s a file in 4 threads (each "
        f"{[round(t, 3) for t in paths['cob_write_s']]})")
    accum = 4
    flags = ["--cfg", os.path.join(REPO, "configs", "resnet50_voc.yaml"), "--device", "cuda",
             "--iter_size", str(accum), "--disp_interval", "1", "--seed", str(SEED), "--set",
             "TPU.PALLAS_ROI_ALIGN", "True", "TPU.PRECISION", "bf16_compute",
             "TRAIN.DATASETS", "('chip_smoke_train',)",
             "TRAIN.PROPOSAL_FILES", f"('{paths['props']}',)",
             "TRAIN.REFINE_FILES", f"('{paths['label_assign']}',)",
             "iou_dir", paths["iou_dir"], "asy_iou_dir", paths["asy_iou_dir"],
             "DATA_DIR", data_dir, "TRAIN.SNAPSHOT_ITERS", str(CLI_SNAPSHOT * accum)]
    out = os.path.join(work_dir, "train_cli_out")
    traced = (CLI_SNAPSHOT + 1, CLI_SNAPSHOT + 2)  # the fifth step: it writes no snapshot
    _zero_launches()
    run = train_cli.main(flags + ["--max_iter", str(CLI_STEPS), "--output_dir", out]
                         + (["--profile_dir", os.path.join(work_dir, "profile")] if profile else []),
                         profile_steps=traced)
    fwd, bwd = roi_align.kernel_launches, roi_align_backward.kernel_launches
    check(run["step"] == CLI_STEPS and len(run["metrics"]) == CLI_STEPS,
          f"the CLI ran {run['step']} steps and logged {len(run['metrics'])}")
    check(fwd == bwd == CLI_STEPS * accum,
          f"{fwd} forward / {bwd} backward kernel launches for {CLI_STEPS} steps x {accum}")
    _record_nms("train_cli", CLI_STEPS * accum)
    for step, m in run["metrics"]:
        check(all(np.isfinite(v) for v in m.values()), f"CLI step {step}: finite metrics {m}")
    snapshot = os.path.join(out, "ckpt", f"model_step{CLI_SNAPSHOT}.pth")
    check(os.path.exists(snapshot), f"snapshot {snapshot}")
    # after the first step (warm-up), without the steps that wrote a
    # snapshot and those the profiler ran in or stopped after
    traced = range(traced[0], traced[1] + 1) if profile else ()
    steady = [i for i in range(1, CLI_STEPS) if i + 1 not in run["snapshots"] and i not in traced]
    loop = [run["loop_s"][i] for i in steady]
    wait = [run["loader_wait_s"][i] for i in steady]
    log(f"[train_cli] {card}: {CLI_STEPS} steps of {accum} images through the CLI over an "
        f"on-disk set of {CLI_IMAGES} images (written in {write_s:.1f} s): s/step median "
        f"{np.median(loop):.4f} over steps {[i + 1 for i in steady]} (each step "
        f"{[round(s, 4) for s in run['loop_s']]}; the first warms up, steps {run['snapshots']} "
        f"write a 2 GB snapshot{', steps 5-6 hold the profiler' if profile else ''}), loader wait {100 * sum(wait) / sum(loop):.1f} % of those "
        f"steps' loop (each step {[round(s, 4) for s in run['loader_wait_s']]}), loader build "
        f"{np.median(run['loader_build_s']):.4f} s a batch of {accum} on the host (median of "
        f"{len(run['loader_build_s'])}: decode, resize, IoU pickles, pinning); launches forward "
        f"{fwd}, backward {bwd}, NMS {NMS_LAUNCHES['train_cli']}; losses {[round(m['total_loss'], 4) for _, m in run['metrics']]}")
    if run["profile"]:
        p = run["profile"]
        log(f"[train_cli] profile of {p['steps']} step(s): device busy {p['device_busy_ms']:.1f} "
            f"of {p['wall_ms']:.1f} ms, idle share {100 * p['idle_share']:.1f} %")

    resumed = train_cli.main(flags + ["--max_iter", str(CLI_STEPS), "--output_dir",
                                      out + "_resumed", "--resume", "--load_ckpt", snapshot,
                                      "--no_save"])
    check([s for s, _ in resumed["metrics"]] == list(range(CLI_SNAPSHOT, CLI_STEPS)),
          f"the resumed run's steps {[s for s, _ in resumed['metrics']]}")
    worst = 0.0
    for (step, got), (_, want) in zip(resumed["metrics"], run["metrics"][CLI_SNAPSHOT:]):
        for k, v in want.items():
            worst = max(worst, abs(got[k] - v) / max(abs(v), 1e-30))
            check(abs(got[k] - v) <= 1e-6 + 1e-5 * abs(v),
                  f"resumed CLI step {step}: {k} {got[k]} vs uninterrupted {v}")
    log(f"[train_cli] resumed from {os.path.basename(snapshot)}: steps {CLI_SNAPSHOT}-"
        f"{CLI_STEPS - 1} give the uninterrupted run's metrics (worst relative difference "
        f"{worst:.3g}); total_loss {[round(m['total_loss'], 6) for _, m in resumed['metrics']]}")
    cli = {"flags": flags, "metrics": run["metrics"], "s_step": float(np.median(loop))}
    return fwd, bwd, paths, os.path.join(out, "ckpt"), cli


# ------------------------------------------------------------- data parallel

def _ddp_reference_cfg():
    """phase_train_reference's float32 config (anti-noise off), one
    microbatch a step."""
    cfg = _train_cfg()
    cfg.TPU.PRECISION = "f32"
    cfg.TPU.GRAD_ACCUM = 1
    cfg.Anti_noise_sampling = False
    return cfg


def _ddp_batches():
    """Three steps' batches of train_reference's small microbatch (a
    128x160 image, 64 proposals): the one both ranks share, A and B."""
    rng = np.random.RandomState(SEED + 7)
    return [{k: v[None] for k, v in make_microbatch(
        rng, image_hw=(128, 160), n_props=64, n_valid=60, num_classes=20).items()}
        for _ in range(3)]


def _seeded_trainer(cfg, device, seed):
    """A trainer with seeded random weights and frozen-BN statistics: the
    same on every rank and in this process."""
    gen = torch.Generator(device=device).manual_seed(seed)
    trainer = Trainer(cfg, device=device, seed=SEED, init_generator=gen)
    _randomize_frozen_bn(trainer.model, gen)
    return trainer


def _momentum(trainer):
    """The SGD momentum buffers on the host: after the first step, the
    step's change over -lr, before it is rounded into the parameters."""
    return {n: b.cpu() for (n, _), b in zip(trainer.optimizer.params, trainer.optimizer.buf)}


def _deterministic_cudnn():
    """cuDNN's deterministic algorithms, TF32 off: its float32 weight
    gradients otherwise sum in an order that changes from run to run, which
    phase ddp's float32 checks would read as a difference between ranks."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                      allow_tf32=False)


def _ddp_rank(device, ref_cfg, batches, timed_cfg):
    """One of phase ddp's two gloo ranks on one card: (a) 2 float32 steps
    on the shared batch, (b) one on batch A (rank 0) or B (rank 1), each
    from the seeded weights; then the bf16 timed run on the rank's own
    scale-480 batch. Returns each run's metrics and launches, whether the
    rank's parameters equal rank 1's bit for bit, and from rank 0 the
    parameters and momentum buffers."""
    import gc

    import torch.distributed as dist

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = parallel.rank()

    def run(batch, steps, keep_params):
        roi_align.kernel_launches = roi_align_backward.kernel_launches = 0
        trainer = _seeded_trainer(ref_cfg, device, SEED + 7)
        metrics = [trainer.step(batch) for _ in range(steps)]
        out = {"metrics": metrics, "launches": (roi_align.kernel_launches,
                                                roi_align_backward.kernel_launches)}
        equal = True
        for p in trainer.model.parameters():
            q = p.detach().clone()
            dist.broadcast(q, src=1)
            equal = equal and torch.equal(q, p.detach())
        out["equal_to_rank1"] = equal
        if rank == 0:
            out["momentum"] = _momentum(trainer)
            if keep_params:
                out["params"] = {n: p.detach().cpu() for n, p in trainer.model.named_parameters()}
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        return out

    with _deterministic_cudnn():
        result = {"same": run(batches[0], 2, True), "mean": run(batches[1 + rank], 1, False)}
    batch = _train_batch(timed_cfg, np.random.RandomState(SEED + 10 + rank), TRAIN_SCALES[0],
                         TRAIN_N_VALID[0])
    trainer = _seeded_trainer(timed_cfg, device, SEED + 4)
    torch.cuda.reset_peak_memory_stats()
    # warm: DDP's first step allocates the gradients, its second rebuilds the buckets
    _timed_steps(trainer, batch, 2)
    warm_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    timed = _timed_steps(trainer, batch, DDP_TIMED_STEPS)
    result["timed"] = {"s": [t for t, _ in timed], "metrics": timed[-1][1],
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "warm_peak_gb": warm_peak,
                       "launches": (roi_align.kernel_launches, roi_align_backward.kernel_launches),
                       "nms_launches": greedy_nms_from_iou.kernel_launches}
    # for comparison, not on the main path: one step with the gradients set
    # to None, as a trainer without DDP zeroes them, so that each step
    # allocates them anew and the reducer copies them into its buckets
    optimizer = trainer.optimizer
    optimizer.zero_grad = lambda set_to_none=True: type(optimizer).zero_grad(optimizer, True)
    torch.cuda.reset_peak_memory_stats()
    _timed_steps(trainer, batch, 1)
    result["timed"]["set_to_none_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return result


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_ddp(work_dir, card, cli):
    """Data parallelism (parallel.launch, engine.train's DDP wrapper) on
    the one card: (1) two gloo ranks on cuda:0, float32 full width, TF32
    and anti-noise off, cuDNN's deterministic algorithms on both sides,
    against world-1 Trainers here: (a) both on the
    same batch, 2 steps: the ranks' parameters bit-equal, the metrics
    within rtol 1e-5 of world 1's, the momentum buffers (the steps' summed
    changes) within 1e-4 of each tensor's largest; (b) batches A and B, one
    step: each tensor's first-step change (its momentum buffer) within
    1e-4 of its largest of the mean of world-1 runs on A and on B; both
    kernels launched in both ranks; then the bf16 model timed on two
    ranks sharing the card. (2) The training CLI under torchrun's
    environment at world size 1 over NCCL, DDP_CLI_STEPS steps of the
    train_cli phase's set: its metrics within 1e-5 relative of that
    phase's, its snapshot (one, at the end) free of ``module.`` keys and
    loaded by a world-1 Trainer; its s/step beside train_cli's.
    (3) BatchedEvaluator over devices ["cuda:0", "cuda:0"] against one
    device on phase_batched_reference's stack. Returns the launches of
    the CLI's run and of the two-rank timed run (both ranks)."""
    t_phase = time.perf_counter()
    ref_cfg, batches = _ddp_reference_cfg(), _ddp_batches()
    refs = {}
    for name, batch, steps in (("same", batches[0], 2), ("A", batches[1], 1),
                               ("B", batches[2], 1)):
        trainer = _seeded_trainer(ref_cfg, "cuda", SEED + 7)
        with _deterministic_cudnn():
            metrics = [trainer.step(batch) for _ in range(steps)]
        refs[name] = {"metrics": metrics, "momentum": _momentum(trainer),
                      "params": {n: p.detach().cpu() for n, p in trainer.model.named_parameters()}
                      if name == "same" else None}
        del trainer
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = parallel.launch(_ddp_rank, 2, "cuda:0", args=(ref_cfg, batches, _train_cfg()),
                            backend="gloo")
    ranks_s = time.perf_counter() - t0

    for r in (0, 1):
        for name, steps in (("same", 2), ("mean", 1)):
            got = ranks[r][name]
            check(got["equal_to_rank1"], f"ddp ({name}): rank {r}'s parameters equal rank 1's")
            check(got["launches"] == (steps, steps),
                  f"ddp ({name}) rank {r}: launches {got['launches']} for {steps} step(s)")
        for got, want in zip(ranks[r]["same"]["metrics"], refs["same"]["metrics"]):
            for k, v in want.items():
                check(abs(got[k] - v) <= 1e-6 + 1e-5 * abs(v),
                      f"ddp (a) rank {r}: {k} {got[k]} vs world 1 {v}")
    # the detector's softmax runs over proposals, so its per-class bias
    # has a zero gradient but for rounding (as in phase train)
    skip = "cls_iou_model.detector.bias"

    def worst(got, want):
        errs = []
        for n, w in want.items():
            if n == skip:
                continue
            w = w.cuda()
            scale = w.abs().max().item()
            err = (got[n].cuda() - w).abs().max().item()
            errs.append((err / max(scale, 1e-30), n, err, scale))
        errs.sort(reverse=True)
        over = [f"{n} by {e:.3g} of {sc:.3g}" for r, n, e, sc in errs if r > 1e-4]
        check(not over, f"ddp: {len(over)} tensors differ by more than 1e-4 of their max: "
                        f"{over[:5]}")
        return errs[0][:2]

    same = ranks[0]["same"]
    bit_equal = sum(torch.equal(same["params"][n], p) for n, p in refs["same"]["params"].items())
    param_err = max((same["params"][n] - p).abs().max().item()
                    for n, p in refs["same"]["params"].items())
    worst_a = worst(same["momentum"], refs["same"]["momentum"])
    mean = {n: (refs["A"]["momentum"][n] + refs["B"]["momentum"][n]) / 2
            for n in refs["A"]["momentum"]}
    worst_b = worst(ranks[0]["mean"]["momentum"], mean)
    log(f"[ddp] two gloo ranks on cuda:0 (parallel.launch, DDP), float32 full width, "
        f"{sum(p.numel() for p in refs['same']['params'].values()):,} parameters: (a) the same "
        f"batch on both ranks, 2 steps: ranks' parameters bit-equal; losses "
        f"{[round(m['total_loss'], 6) for m in same['metrics']]} vs world 1 "
        f"{[round(m['total_loss'], 6) for m in refs['same']['metrics']]}; parameters bit-equal "
        f"to world 1's in {bit_equal} of {len(refs['same']['params'])} tensors (max |diff| "
        f"{param_err:.3g}); momentum worst {worst_a[0]:.3g} of its tensor's max ({worst_a[1]})")
    log(f"[ddp] (b) batches A and B, one step: each tensor's change (momentum buffer) against "
        f"the mean of world-1 runs on A and B: worst {worst_b[0]:.3g} of its tensor's max "
        f"({worst_b[1]}); launches a rank (forward, backward): "
        f"{[ranks[r]['mean']['launches'] for r in (0, 1)]}; {ranks_s:.1f} s for the spawned ranks")
    timed = [ranks[r]["timed"] for r in (0, 1)]
    for r, t in enumerate(timed):
        check(t["launches"] == (DDP_TIMED_STEPS * _train_cfg().TPU.GRAD_ACCUM,) * 2,
              f"ddp timed rank {r}: launches {t['launches']}")
        check(all(np.isfinite(v) for v in t["metrics"].values()), f"ddp timed rank {r}: finite")
    _record_nms("train_ddp_gloo2", 2 * DDP_TIMED_STEPS * _train_cfg().TPU.GRAD_ACCUM,
                sum(t["nms_launches"] for t in timed))
    log(f"[ddp] {card}: TWO RANKS SHARING ONE CARD (gloo moves the gradients through host "
        f"memory; not multi-GPU speed): resnet50_voc bf16 full width, GRAD_ACCUM 4, scale-480 "
        f"batches of 2000 proposals, s/step of each rank {[[round(s, 4) for s in t['s']] for t in timed]}"
        f" (median {np.median([s for t in timed for s in t['s']]):.4f}), peak device memory a rank "
        f"over the timed steps {[round(t['peak_gb'], 2) for t in timed]} GB (gradients zeroed in "
        f"place, DDP's bucket views; over the 2 warm steps {[round(t['warm_peak_gb'], 2) for t in timed]}"
        f"; a step with the gradients set to None {[round(t['set_to_none_peak_gb'], 2) for t in timed]}"
        f"), total_loss "
        f"{[round(t['metrics']['total_loss'], 4) for t in timed]}")
    del refs, ranks

    # the CLI at world size 1 over NCCL, as torchrun would start it
    flags = list(cli["flags"])
    flags[flags.index("TRAIN.SNAPSHOT_ITERS") + 1] = "1000"  # one snapshot, at the end
    out = os.path.join(work_dir, "train_ddp_out")
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port())}
    before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    _zero_launches()
    try:
        run = train_cli.main(flags + ["--max_iter", str(DDP_CLI_STEPS), "--output_dir", out])
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    fwd, bwd = roi_align.kernel_launches, roi_align_backward.kernel_launches
    check(run["world"] == 1 and run["ddp"], "the torchrun CLI ran one rank under DDP")
    check(fwd == bwd == DDP_CLI_STEPS * 4, f"ddp CLI: {fwd} / {bwd} launches")
    _record_nms("train_ddp", DDP_CLI_STEPS * 4)
    check([s for s, _ in run["metrics"]] == list(range(DDP_CLI_STEPS)), "ddp CLI steps")
    rel = 0.0
    for (step, got), (_, want) in zip(run["metrics"], cli["metrics"]):
        for k, v in want.items():
            rel = max(rel, abs(got[k] - v) / max(abs(v), 1e-30))
            check(abs(got[k] - v) <= 1e-6 + 1e-5 * abs(v),
                  f"ddp CLI step {step}: {k} {got[k]} vs train_cli {v}")
    snapshot = os.path.join(out, "ckpt", f"model_step{DDP_CLI_STEPS}.pth")
    state = torch.load(snapshot, map_location="cpu", weights_only=True)["model"]
    check(not any(k.startswith("module.") for k in state), "the DDP snapshot's keys are bare")
    cfg, _ = train_cli._configure(train_cli.parse_args(flags))
    single = Trainer(cfg, device="cuda")
    load_ckpt(os.path.dirname(snapshot), single, DDP_CLI_STEPS)
    check(single.ddp is None and single.step_count == DDP_CLI_STEPS, "snapshot loads at world 1")
    del single, state
    s_step = float(np.median(run["loop_s"][1:]))  # no step writes a snapshot
    log(f"[ddp] {card}: the training CLI under torchrun's environment (WORLD_SIZE 1, NCCL, DDP): "
        f"{DDP_CLI_STEPS} steps equal the train_cli phase's (worst relative difference "
        f"{rel:.3g}); s/step median {s_step:.4f} over steps 2-{DDP_CLI_STEPS} (each step "
        f"{[round(s, 4) for s in run['loop_s']]}, the first warms up) against train_cli's "
        f"{cli['s_step']:.4f} (steps without a snapshot) in this process; "
        f"launches {fwd} / {bwd}; its snapshot's keys bare, loaded by a world-1 Trainer")

    # a stack split over two devices (here both cuda:0)
    cfg32, items = _batched_reference_setup(_train_cfg())
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    m = build_model(cfg32, device="cuda", generator=gen)
    _randomize_frozen_bn(m, gen)
    want = BatchedEvaluator(cfg32, m, 2, device="cuda").im_detect_all_many(items)
    roi_align.kernel_launches = 0
    got = BatchedEvaluator(cfg32, m, 2, devices=["cuda:0", "cuda:0"]).im_detect_all_many(items)
    passes = len(Evaluator.tta_pass_list(cfg32))
    check(roi_align.kernel_launches == 2 * passes,
          f"ddp eval: {roi_align.kernel_launches} forward launches, one a sub-stack and pass")
    err = 0.0
    for (g, _), (w, _) in zip(got, want):
        err = max(err, float(np.abs(g - w).max()))
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-5)
    del m
    log(f"[ddp] BatchedEvaluator over devices [cuda:0, cuda:0], float32 full width, a stack of 2 "
        f"images in 2 sub-stacks, {passes} TTA passes: {2 * passes} forward launches; against "
        f"one device max_abs_err {err:.3g}; phase {time.perf_counter() - t_phase:.1f} s")
    return fwd, bwd, sum(t["launches"][0] for t in timed), sum(t["launches"][1] for t in timed)


def _is_proposal_mask(segm, masks, boxes) -> bool:
    """Whether an RLE decodes to the mask of a proposal whose box is its
    bounding box (the synthetic proposals' boxes are their masks' tight
    boxes, inclusive)."""
    x, y, w, h = rle_util.to_bbox(segm)
    cand = np.nonzero((boxes[:, 0] == x) & (boxes[:, 1] == y) & (boxes[:, 2] == x + w - 1)
                      & (boxes[:, 3] == y + h - 1))[0]
    dec = rle_util.decode(segm)
    return any(np.array_equal(dec, masks[i]) for i in cand)


def _every_class_present(ann_path) -> str:
    """A copy of a set's annotation file in which every image holds an
    object of every class (the class's box and mask those of the image's
    first object). The exporter keeps an image's top 100 detections over
    all classes, then those of its gt classes only; under random weights
    the set's own two gt classes an image can miss the top 100 and leave
    nothing to export; with every class present it keeps the top 100."""
    with open(ann_path) as f:
        ann = json.load(f)
    first = {}
    for a in ann["annotations"]:
        first.setdefault(a["image_id"], a)
    present = {(a["image_id"], a["category_id"]) for a in ann["annotations"]}
    for image_id, a in first.items():
        for c in ann["categories"]:
            if (image_id, c["id"]) not in present:
                ann["annotations"].append(dict(a, id=len(ann["annotations"]) + 1,
                                               category_id=c["id"]))
    path = ann_path[:-len(".json")] + "_every_class.json"
    with open(path, "w") as f:
        json.dump(ann, f)
    return path


def phase_eval_cli(work_dir, card, paths, ckpt_dir):
    """The eval CLIs through their main(), from the train CLI's last
    snapshot over its on-disk set of CLI_IMAGES images: test_net at the
    shipped EVAL_BATCH (one stack), test_net --corloc on the set
    registered as voc_2012_trainaug (the preset name the exporter reads,
    with the set's VOC devkit, every class present in every image),
    evaluation with --cob_dir, the pseudo-label
    export with --cob_dir, change_mask_thr and visualize_results. Returns
    the forward kernel's launches of the two test_net runs."""
    data_dir = os.path.dirname(paths["ann"])
    catalog.register_dataset("voc_2012_trainaug", {
        catalog.IM_DIR: paths["image_dir"], catalog.ANN_FN: _every_class_present(paths["ann"]),
        catalog.DEVKIT_DIR: paths["devkit_dir"]})
    yaml = os.path.join(REPO, "configs", "resnet50_voc.yaml")
    data = ["TEST.PROPOSAL_FILES", f"('{paths['props']}',)", "DATA_DIR", data_dir]
    flags = ["--cfg", yaml, "--device", "cuda", "--load_ckpt", ckpt_dir, "--set",
             "TPU.PALLAS_ROI_ALIGN", "True", "TPU.PRECISION", "bf16_compute", *data]
    out = os.path.join(work_dir, "eval_cli")
    passes = len(Evaluator.tta_pass_list(load_cfg(yaml)))

    roi_align.kernel_launches = 0
    roi_align_backward.kernel_launches = 0
    t0 = time.perf_counter()
    run = test_net_cli.main(flags + ["TEST.DATASETS", "('chip_smoke_train',)",
                                     "--output_dir", os.path.join(out, "test")])
    test_s = time.perf_counter() - t0
    fwd_test = roi_align.kernel_launches
    check(fwd_test == passes, f"{fwd_test} forward launches for one stack of {CLI_IMAGES} x "
          f"{passes} passes")
    check(roi_align_backward.kernel_launches == 0, "test_net launches no backward kernel")
    check(run["step"] == CLI_STEPS, f"test_net loaded step {run['step']}")
    saved = torch.load(os.path.join(ckpt_dir, f"model_step{CLI_STEPS}.pth"), map_location="cpu",
                       weights_only=True)["model"]
    state = run["model"].state_dict()
    check(state.keys() == saved.keys() and all(torch.equal(state[k].cpu(), v)
                                               for k, v in saved.items()),
          "the evaluated model's tensors equal the checkpoint's")
    with open(run["det_file"], "rb") as f:
        dets = pickle.load(f)
    check(len(dets) == CLI_IMAGES, f"{len(dets)} records in detections.pkl")
    for name, rec in dets.items():
        s = rec["scores"]
        check(set(rec) == {"scores", "boxes"}, f"{name}: the pickle holds scores and boxes only")
        check(s.shape == (N_PROPS, 20), f"{name}: scores shape {s.shape}")
        check(np.isfinite(s).all() and s.min() >= 0.0 and s.max() <= 1.0,
              f"{name}: scores finite in [0, 1]")
    res = run["results"]
    check(np.isfinite(res["AP"]) and np.isfinite(res["AP50"]), "finite box AP")
    n_dets = sum(len(d) for per_class in run["all_boxes"][1:] for d in per_class)
    check(n_dets > 0, "test_net kept detections")
    run_s = run["seconds"]
    del run, state, saved

    t0 = time.perf_counter()
    corloc = test_net_cli.main(flags + ["TEST.DATASETS", "('voc_2012_trainaug',)", "--corloc",
                                        "--output_dir", os.path.join(out, "corloc")])
    corloc_s = time.perf_counter() - t0
    fwd = roi_align.kernel_launches
    check(fwd == 2 * passes, f"{fwd - fwd_test} forward launches in the --corloc run")
    check(roi_align_backward.kernel_launches == 0, "test_net launches no backward kernel")
    check(os.path.basename(corloc["det_file"]) == "discovery.pkl"
          and os.path.exists(corloc["det_file"]), "--corloc writes discovery.pkl")
    corloc_value = corloc["results"]["CorLoc"]
    check(np.isfinite(corloc_value), "finite CorLoc")
    discovery = corloc["det_file"]
    del corloc

    cob = {}  # image id -> (its .mat masks, its proposal boxes)
    with open(paths["props"], "rb") as f:
        props = pickle.load(f)
    load_s = []
    for image_id, boxes in zip(props["indexes"], props["boxes"]):
        t0 = time.perf_counter()
        cob[image_id] = (eval_cli.load_cob_masks(paths["cob_dir"], {"id": image_id}), boxes)
        load_s.append(time.perf_counter() - t0)
        check(len(cob[image_id][0]) == N_PROPS, f"image {image_id}: {N_PROPS} .mat masks")

    t0 = time.perf_counter()
    metrics = eval_cli.main(["--cfg", yaml, "--result_path", os.path.join(out, "test", "detections.pkl"),
                             "--dataset", "chip_smoke_train", "--cob_dir", paths["cob_dir"],
                             "--nprocs", "2", "--output_dir", os.path.join(out, "segm"), "--set",
                             "TEST.DATASETS", "('chip_smoke_train',)", *data])
    eval_s = time.perf_counter() - t0
    for t in (25, 50, 70, 75):
        v = metrics[f"mAP{t}"]
        check(np.isfinite(v) and 0.0 <= v <= 1.0, f"mAP{t} {v} finite in [0, 1]")
    with open(os.path.join(out, "segm", "segm_results.json")) as f:
        segm = json.load(f)
    check(len(segm) > 0, "evaluation wrote segm results")
    for r in segm:
        check(_is_proposal_mask(r["segmentation"], *cob[r["image_id"]]),
              f"a segm result of image {r['image_id']} is a proposal's .mat mask")

    t0 = time.perf_counter()
    labels = export_cli.main(["--cfg", yaml, "--result_path", discovery, "--cob_dir",
                              paths["cob_dir"], "--nprocs", "2", "--output_dir",
                              os.path.join(out, "pseudo"), "--set", *data[2:],
                              "TRAIN.PROPOSAL_FILES", f"('{paths['props']}',)"])
    export_s = time.perf_counter() - t0
    with open(labels) as f:
        exported = json.load(f)
    anns = exported["annotations"]
    check(len(exported["images"]) == CLI_IMAGES and len(anns) > 0,
          f"{len(exported['images'])} images, {len(anns)} pseudo labels")
    for a in anns:
        check(_is_proposal_mask(a["segmentation"], *cob[a["image_id"]]),
              f"a pseudo label of image {a['image_id']} is a proposal's .mat mask")
    thr_path = change_mask_thr.main(["--input", labels, "--thr", "0.3"])
    with open(thr_path) as f:
        kept = json.load(f)
    want = [a for a in anns if a["score"] >= 0.3]
    check([a["id"] for a in kept["annotations"]] == list(range(1, len(want) + 1))
          and [a["segmentation"] for a in kept["annotations"]] == [a["segmentation"] for a in want]
          and kept["images"] == exported["images"],
          f"change_mask_thr kept {len(kept['annotations'])} of {len(anns)} (score >= 0.3: "
          f"{len(want)}), renumbered, every image")
    vis_dir = os.path.join(out, "vis")
    drawn = visualize_results.main(["--result_file", os.path.join(out, "segm", "segm_results.json"),
                                    "--image_dir", paths["image_dir"], "--save_dir", vis_dir,
                                    "--max_images", "2", "--score_thr", "0"])
    check(drawn == 2 and len(os.listdir(vis_dir)) == 2, f"visualize_results drew {drawn} images")

    log(f"[eval_cli] {card}: test_net from the step-{CLI_STEPS} snapshot, {CLI_IMAGES} images at "
        f"EVAL_BATCH {EVAL_BATCH}: {test_s:.3f} s end to end, of it model build and checkpoint "
        f"load {run_s['load']:.3f} s, the evaluator {run_s['evaluator']:.3f} s "
        f"({run_s['evaluator'] / CLI_IMAGES:.4f} s/image), the rest of run_inference (image "
        f"reads, pickle, NMS, COCO box eval) {run_s['inference'] - run_s['evaluator']:.3f} s; "
        f"--corloc run {corloc_s:.3f} s; evaluation CLI (--cob_dir, 2 workers) "
        f"{eval_s / CLI_IMAGES:.4f} s/image ({eval_s:.3f} s); export CLI (--cob_dir, 2 workers) "
        f"{export_s / CLI_IMAGES:.4f} s/image ({export_s:.3f} s); a COB .mat of {N_PROPS} "
        f"{IMAGE_HW[0]}x{IMAGE_HW[1]} masks: write {np.mean(paths['cob_write_s']):.3f} s (4 "
        f"threads), load {np.mean(load_s):.3f} s (each {[round(t, 3) for t in load_s]})")
    log(f"[eval_cli] forward launches {fwd_test} + {fwd - fwd_test}, backward 0; box AP "
        f"{res['AP']:.4f}, CorLoc {corloc_value:.4f}; {len(segm)} segm results, mAP25/50/70/75 "
        f"{[round(metrics[f'mAP{t}'], 4) for t in (25, 50, 70, 75)]}; {len(anns)} pseudo labels, "
        f"{len(want)} at score >= 0.3 (random weights)")
    return fwd


# -------------------------------------------------------- preprocessing

def _pickle_load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _gt_classes(ann_path):
    """image id -> its gt classes as AGPL_label_assign takes them (contiguous
    indices of the sorted category ids, sorted)."""
    with open(ann_path) as f:
        ann = json.load(f)
    contig = {c: i for i, c in enumerate(sorted(c["id"] for c in ann["categories"]))}
    out = {im["id"]: set() for im in ann["images"]}
    for a in ann["annotations"]:
        out[a["image_id"]].add(contig[a["category_id"]])
    return {k: sorted(v) for k, v in out.items()}


def _prm_checkpoint(path):
    """A seeded FCResNet50 (frozen-BN statistics randomized) saved as the
    reference saves a PRM: a DataParallel state_dict with BN's
    num_batches_tracked. Returns the CPU model."""
    mapper = PeakResponseMapper(num_classes=20, device="cpu")
    gen = torch.Generator().manual_seed(SEED + 9)
    torch_default_init_(mapper.model, gen)
    _randomize_frozen_bn(mapper.model, gen)
    sd = {"module." + k: v for k, v in mapper.model.state_dict().items()}
    sd.update({"module." + k[:-len("running_var")] + "num_batches_tracked": torch.tensor(0)
               for k in mapper.model.state_dict() if k.endswith("running_var")})
    torch.save({"state_dict": sd}, path)
    return mapper


def _rel_l1(a, b):
    return ((a - b).abs().flatten(1).sum(1) / b.abs().flatten(1).sum(1)).max().item()


def phase_preprocess(work_dir, card, paths, profile=False):
    """The offline preprocessing of the port on the train_cli phase's
    on-disk set (CLI_IMAGES 375x500 JPEGs, N_PROPS full-size COB .mat masks
    each, ann.json with 2 gt classes an image), then a train on its outputs:
    generate_7_7 (2 spawn workers) against the in-process host function;
    create_cob_iou on the card against its --device cpu run on 2 images;
    the float32 PRM on the card against the CPU; AGPL_label_assign on the
    card (--prm_ckpt, a threshold giving each image MIN_PEAKS peaks or
    more) and point_level_label_assign against the host assignment; the
    train CLI 2 steps at iter_size 4 on those files; PRMClassifierTrainer
    at full width. Returns the RoIAlign kernels' launches of the train CLI
    run."""
    out = os.path.join(work_dir, "preprocess")
    os.makedirs(out, exist_ok=True)
    ann, cob = paths["ann"], paths["cob_dir"]
    ids = generate_7_7.image_ids(ann)
    base = ["--ann_file", ann, "--cob_dir", cob]

    # 1. generate_7_7 on the host, 2 spawn workers, against the function in-process
    props = os.path.join(out, "props.pkl")
    run = generate_7_7.main(base + ["--output", props, "--nprocs", "2"])
    got = _pickle_load(props)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        want = list(pool.map(generate_7_7.rasterize_one, [(i, cob, "voc", 7) for i in ids]))
    host_s = time.perf_counter() - t0
    check(got["indexes"] == ids, f"generate_7_7 indexes {got['indexes']}")
    for k, (image_id, boxes, masks, scores) in enumerate(want):
        for key, w in (("boxes", boxes), ("masks", masks), ("scores", scores)):
            g = got[key][k]
            check(g.dtype == w.dtype and np.array_equal(g, w),
                  f"generate_7_7 {key} of image {image_id} equal the host function's")
    log(f"[preprocess] generate_7_7 (host, 2 spawn workers): {CLI_IMAGES} images x {N_PROPS} "
        f"{IMAGE_HW[0]}x{IMAGE_HW[1]} masks in {run['seconds']:.2f} s "
        f"({run['seconds'] / CLI_IMAGES:.3f} s/image), the pkl equal to the function in-process "
        f"({host_s:.2f} s in 4 threads)")

    # 2. create_cob_iou on the card; its --device cpu run on 2 of the images
    iou = {d: os.path.join(out, d) for d in ("iou", "asy", "iou_cpu", "asy_cpu")}
    run = iou_cli.main(base + ["--device", "cuda", "--iou_dir", iou["iou"],
                               "--asy_iou_dir", iou["asy"]])
    with open(ann) as f:
        two = json.load(f)
    two["images"] = sorted(two["images"], key=lambda im: im["id"])[:2]
    ann2 = os.path.join(out, "ann_2.json")
    with open(ann2, "w") as f:
        json.dump(two, f)
    t0 = time.perf_counter()
    iou_cli.main(["--ann_file", ann2, "--cob_dir", cob, "--device", "cpu",
                  "--iou_dir", iou["iou_cpu"], "--asy_iou_dir", iou["asy_cpu"]])
    cpu_s = time.perf_counter() - t0
    names = sorted(os.listdir(iou["iou_cpu"]))
    check(len(names) == 2 and len(os.listdir(iou["iou"])) == CLI_IMAGES, f"IoU pkls {names}")
    for name in names:
        for d in ("iou", "asy"):
            g, w = _pickle_load(os.path.join(iou[d], name)), _pickle_load(
                os.path.join(iou[d + "_cpu"], name))
            check(g.dtype == w.dtype == np.float16 and g.shape == (N_PROPS, N_PROPS)
                  and np.array_equal(g.view(np.uint16), w.view(np.uint16)),
                  f"{d} of {name}: the card's float16 matrix is the CPU's, bit for bit")
    flops = 2.0 * N_PROPS * N_PROPS * IMAGE_HW[0] * IMAGE_HW[1]
    prod = np.asarray(run["product_ms"][1:])  # the first call picks cuBLAS's kernel
    log(f"[preprocess] create_cob_iou {card}: {np.mean(run['image_s']):.4f} s/image (each "
        f"{[round(t, 3) for t in run['image_s']]}), of it the .mat load "
        f"{np.mean(run['load_s']):.4f} s and the product on the card (CUDA events, upload "
        f"excluded) {np.median(prod):.3f} ms median of images 2-{CLI_IMAGES} (each "
        f"{[round(t, 3) for t in run['product_ms']]}; {flops / 1e12:.3f} TFLOP an image: "
        f"{flops / np.median(prod) / 1e9:.1f} TFLOP/s, bound {1e3 * flops / 67e12:.2f} ms at "
        f"67 TFLOP/s float32), peak device memory {run['peak_bytes'] / 1e9:.2f} GB; the "
        f"--device cpu run of 2 images {cpu_s:.1f} s, bit-equal")

    # 3. the PRM in float32 (TF32 off): the card against the CPU on one image
    ckpt = os.path.join(out, "prm_reference_named.pth")
    cpu = _prm_checkpoint(ckpt)
    card_prm = PeakResponseMapper(num_classes=20, device="cuda")
    load_prm_checkpoint(card_prm.model, ckpt)
    gts = _gt_classes(ann)
    with open(ann) as f:
        files = {im["id"]: im["file_name"] for im in json.load(f)["images"]}
    images = {i: agpl_cli.load_prm_image(os.path.join(paths["image_dir"], files[i])) for i in ids}
    v16 = {}
    for i in ids:  # the threshold: each image keeps MIN_PEAKS peaks of its gt classes
        crm, pm = (t.cpu().numpy() for t in card_prm.crm_and_peaks(images[i]))
        vals = np.sort(np.concatenate([crm[c][pm[c]] for c in gts[i]]))[::-1]
        check(len(vals) >= MIN_PEAKS, f"image {i}: {len(vals)} peaks of gt classes {gts[i]}")
        v16[i] = float(vals[MIN_PEAKS - 1])
    threshold = min(v16.values()) - 1e-4 * abs(min(v16.values()))
    img = images[ids[0]]
    crm_cpu, pm_cpu = cpu.crm_and_peaks(img)
    crm_card, pm_card = card_prm.crm_and_peaks(img)
    scale = crm_cpu.abs().max().item()
    err = (crm_card.cpu() - crm_cpu).abs().max().item()
    check(np.isfinite(scale) and scale > 0 and err <= 1e-4 * scale,
          f"PRM CRM card vs CPU: max_abs_err {err:.3g} of max {scale:.3g}")
    pm_on_card = find_peaks(crm_cpu[None].cuda())[0].cpu()
    check(torch.equal(pm_on_card, pm_cpu), "find_peaks of the CPU's CRM: the card's map equal")
    cpu.peak_threshold = threshold
    sel = cpu.select_peaks(crm_cpu.numpy(), pm_cpu.numpy(), gts[ids[0]])[:PRM_CPU_PEAKS]
    peaks = np.array([p[:3] for p in sel], np.int64)
    t0 = time.perf_counter()
    prm_cpu = cpu.peak_response_maps(img, peaks)
    cpu_prm_s = time.perf_counter() - t0
    prm_card = card_prm.peak_response_maps(img, peaks).cpu()
    rel = _rel_l1(prm_card, prm_cpu)
    check(len(peaks) == PRM_CPU_PEAKS and rel <= 1e-3,
          f"{len(peaks)} peak response maps card vs CPU: relative L1 {rel:.3g}")
    agree = (pm_card.cpu() == pm_cpu).all().item()
    n_diff = int((pm_card.cpu() != pm_cpu).sum())
    log(f"[preprocess] PRM float32 {card}: CRM {tuple(crm_cpu.shape)} card vs CPU max_abs_err "
        f"{err:.3g} of max {scale:.3g}; find_peaks of the CPU's CRM equal on both; the response "
        f"maps of the CPU's first {len(peaks)} peaks (threshold {threshold:.6g}) relative L1 "
        f"{rel:.3g} (CPU {cpu_prm_s:.1f} s)")
    log(f"[preprocess] peak-set agreement (each device's own CRM): "
        f"{'equal' if agree else f'{n_diff} of {pm_cpu.numel()} positions differ'} "
        f"({int(pm_cpu.sum())} peaks on the CPU)")
    del cpu, prm_cpu, prm_card

    # the most peaks inference_gt passes: MAX_PEAKS image copies in one forward and backward
    full = np.argwhere(pm_card.cpu().numpy())[:MAX_PEAKS][:, [1, 2, 0]]  # (y, x, class)
    check(len(full) == MAX_PEAKS, f"{len(full)} peaks in the card's CRM, {MAX_PEAKS} wanted")
    full_s = []
    for _ in range(2):  # the first call builds cuDNN's plans for a batch of MAX_PEAKS
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        maps = card_prm.peak_response_maps(img, full)
        torch.cuda.synchronize()
        full_s.append(time.perf_counter() - t0)
    full_gb = torch.cuda.max_memory_allocated() / 1e9
    few = card_prm.peak_response_maps(img, full[:PRM_CPU_PEAKS])
    few_err = _rel_l1(maps[:PRM_CPU_PEAKS].cpu(), few.cpu())
    sums = maps.sum(dim=(1, 2))
    check(bool(torch.isfinite(maps).all()) and (sums - 1).abs().max().item() < 1e-4
          and few_err <= 1e-3 and full_gb <= PRM_MEMORY_CAP_GB,
          f"{MAX_PEAKS} response maps in one pass: peak device memory {full_gb:.2f} GB (cap "
          f"{PRM_MEMORY_CAP_GB}), the first {PRM_CPU_PEAKS} within relative L1 {few_err:.3g} of a "
          f"pass of {PRM_CPU_PEAKS}")
    log(f"[preprocess] peak backprop {card}: {MAX_PEAKS} copies of the 448x448 image in one "
        f"forward and backward, {full_s[1]:.4f} s (first call {full_s[0]:.4f} s), peak device "
        f"memory {full_gb:.2f} GB (cap {PRM_MEMORY_CAP_GB} GB); its first {PRM_CPU_PEAKS} maps "
        f"those of a pass of {PRM_CPU_PEAKS} within relative L1 {few_err:.3g}")
    del maps, few

    # 4. AGPL_label_assign on the card, against the host assignment of its peaks
    label_assign = os.path.join(out, "label_assign.pkl")
    torch.cuda.reset_peak_memory_stats()
    run = agpl_cli.main(base + ["--img_dir", paths["image_dir"], "--output", label_assign,
                                "--prm_ckpt", ckpt, "--peak_threshold", repr(threshold),
                                "--device", "cuda"])
    agpl_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mats = _pickle_load(label_assign)
    check(mats["indexes"] == ids, f"AGPL indexes {mats['indexes']}")
    with ThreadPoolExecutor(4) as pool:
        masks = dict(zip(ids, pool.map(
            lambda i: generate_7_7.load_cob_mat(generate_7_7.mat_path_for(cob, i, "voc")), ids)))
    for k, i in enumerate(ids):
        n, la = run["num_peaks"][k], mats["mat"][k]
        check(MIN_PEAKS <= n <= MAX_PEAKS, f"image {i}: {n} peaks")
        check((np.count_nonzero(la, axis=1) <= 1).all(), f"image {i}: one cluster a proposal")
        pk = np.zeros((MAX_PEAKS, 3), np.int32)
        sc = np.zeros(MAX_PEAKS, np.float32)
        pk[:n], sc[:n] = run["peaks"][k], run["peak_scores"][k]
        host = agpl_cli.assign_image(masks[i], pk, sc, n, 20, device="cpu")
        check(np.array_equal(la, host), f"image {i}: the card's assignment is the host's")
    image_s = np.add(np.add(run["load_s"], run["prm_s"]), run["assign_s"])
    log(f"[preprocess] AGPL_label_assign {card}: peak threshold {threshold!r}, K "
        f"{run['num_peaks']}; s/image {np.mean(image_s):.4f}: load "
        f"(JPEG + .mat) {np.mean(run['load_s']):.4f}, PRM block (host clock to the maps' copy "
        f"back) {np.mean(run['prm_s']):.4f} (each {[round(t, 3) for t in run['prm_s']]}; the "
        f"first builds cuDNN's plans), assignment {np.mean(run['assign_s']):.4f}; peak device "
        f"memory {agpl_peak_gb:.2f} GB; clusters an image "
        f"{[int(m.max()) for m in mats['mat']]}; the host's assignment equal on every image")
    if profile:
        _profile_prm(card_prm, images[ids[0]], gts[ids[0]], threshold)
    del card_prm

    # 5. point_level_label_assign on the card: points inside known proposals
    pts_dir = os.path.join(out, "Center_points")
    os.makedirs(pts_dir, exist_ok=True)
    points = {}
    for i in ids:
        pts = []
        for j, p in enumerate((0, 1, 5)):
            ys, xs = np.nonzero(masks[i][p])
            pts.append((float(xs[len(xs) // 2]), float(ys[len(ys) // 2]), (i + j) % 20, 1.0))
        points[i] = pts
        with open(os.path.join(pts_dir, eval_cli.cob_mat_name({"id": i})[:-4] + ".txt"), "w") as f:
            f.write("".join(f"{x:g} {y:g} {c} {p:g}\n" for x, y, c, p in pts))
    point_mats = os.path.join(out, "point_label_assign.pkl")
    points_cli.main(base + ["--points_dir", pts_dir, "--output", point_mats, "--device", "cuda"])
    got = _pickle_load(point_mats)
    for k, i in enumerate(ids):
        host = points_cli.assign_from_points(masks[i], points[i], 20, device="cpu")
        check(np.array_equal(got["mat"][k], host) and got["mat"][k].max() >= 1,
              f"image {i}: the card's point assignment is the host's")
    log(f"[preprocess] point_level_label_assign {card}: 3 points an image inside proposals "
        f"0, 1 and 5, the host's assignment on every image")
    del masks

    # 6. the train CLI on the port's own outputs
    accum = 4
    flags = ["--cfg", os.path.join(REPO, "configs", "resnet50_voc.yaml"), "--device", "cuda",
             "--iter_size", str(accum), "--max_iter", "2", "--no_save", "--disp_interval", "1",
             "--seed", str(SEED), "--output_dir", os.path.join(out, "train"), "--set",
             "TPU.PALLAS_ROI_ALIGN", "True", "TPU.PRECISION", "bf16_compute",
             "TRAIN.DATASETS", "('chip_smoke_train',)", "TRAIN.PROPOSAL_FILES", f"('{props}',)",
             "TRAIN.REFINE_FILES", f"('{label_assign}',)", "iou_dir", iou["iou"],
             "asy_iou_dir", iou["asy"], "DATA_DIR", os.path.dirname(ann)]
    _zero_launches()
    run = train_cli.main(flags)
    fwd, bwd = roi_align.kernel_launches, roi_align_backward.kernel_launches
    check(run["step"] == 2 and fwd == bwd == 2 * accum,
          f"train CLI on the preprocessed files: {run['step']} steps, {fwd} forward / {bwd} "
          f"backward launches")
    _record_nms("train_cli_pre", 2 * accum)
    for step, m in run["metrics"]:
        check(all(np.isfinite(v) for v in m.values()), f"step {step}: finite metrics {m}")
    log(f"[preprocess] train CLI {card} on the port's own props.pkl, IoU pkls and AGPL "
        f"label_assign.pkl: 2 steps of {accum}, s/step {[round(s, 4) for s in run['loop_s']]}, "
        f"launches forward {fwd}, backward {bwd}; total_loss "
        f"{[round(m['total_loss'], 4) for _, m in run['metrics']]}")

    # 7. PRMClassifierTrainer at full width
    trainer = PRMClassifierTrainer(num_classes=20, base_lr=0.01, groups={"features": 0.01},
                                   device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    torch_default_init_(trainer.model, gen)
    _randomize_frozen_bn(trainer.model, gen)
    before = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    rng = np.random.RandomState(SEED + 10)
    images = rng.randn(PRM_BATCH, 448, 448, 3).astype(np.float32)
    targets = (rng.rand(PRM_BATCH, 20) < 0.15).astype(np.float32)
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [trainer.step(images, targets).item()], []
    for _ in range(PRM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.step(images, targets)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(loss.item())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    after = trainer.model.state_dict()
    moved = {k: (after[k] - before[k]).abs().max().item()
             for k in ("classifier.0.weight", "features.0.weight")}
    check(all(np.isfinite(losses)), f"PRM trainer losses {losses}")
    check(0 < moved["features.0.weight"] < moved["classifier.0.weight"],
          f"the classifier moved ({moved['classifier.0.weight']:.3g}) more than the features "
          f"group ({moved['features.0.weight']:.3g})")
    check(all(torch.equal(after[k], before[k]) for k in before if "running_" in k),
          "frozen-BN statistics unchanged")
    flops = 3 * 2 * 4.1e9 * (448 / 224) ** 2 * PRM_BATCH
    log(f"[preprocess] PRMClassifierTrainer {card}: FCResNet50, 20 classes, {PRM_BATCH} x "
        f"448x448 float32 (TF32 off): s/step median {np.median(secs):.4f} (each "
        f"{[round(t, 4) for t in secs]}), {PRM_BATCH / np.median(secs):.1f} images/s (~{flops / 1e12:.2f} "
        f"TFLOP a step: {flops / np.median(secs) / 1e12:.1f} TFLOP/s), peak device memory "
        f"{peak_gb:.2f} GB; losses {[round(v, 5) for v in losses]}; max |change| classifier "
        f"{moved['classifier.0.weight']:.3g}, features.0 {moved['features.0.weight']:.3g}")

    return fwd, bwd


def _profile_prm(mapper, image, gt_classes, threshold):
    """Device time of one image's PRM block (inference_gt) by operator."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    mapper.peak_threshold = threshold
    mapper.inference_gt(image, gt_classes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = mapper.inference_gt(image, gt_classes)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3
    log(f"[profile] PRM block of one image ({out.num_peaks} peaks): device busy {device_ms:.1f} "
        f"ms of {wall_ms:.1f} ms under the profiler")
    log(events.table(sort_by="self_device_time_total", row_limit=15, max_name_column_width=70))


# ------------------------------------------------------------ eval paths

def _eval_items(roidb, n):
    return [(_image_loader(e), e["boxes"], e["masks"]) for e in roidb[:n]]


def _per_pass_cfg(cfg, **aug):
    """``cfg`` on the per-pass path (TPU.FUSED_TTA off), with the given
    TEST.BBOX_AUG fields."""
    cfg = clone_cfg(cfg)
    cfg.TPU.FUSED_TTA = False
    for k, v in aug.items():
        cfg.TEST.BBOX_AUG[k] = v
    return cfg


def _deviation(got, want):
    """max and mean of |got - want| over lists of score arrays."""
    d = np.concatenate([np.abs(g - w).ravel() for g, w in zip(got, want)])
    return float(d.max()), float(d.mean())


def _within_ulp(got, want) -> bool:
    """Every element of the card's float32 tensor within 1 ulp of the CPU's."""
    g, w = got.cpu().numpy(), want.numpy()
    return bool((np.abs(g - w) <= np.spacing(np.abs(w))).all())


def phase_eval_paths(card, model, data_dir, props, profile=False):
    """Every eval configuration cim_tpu evaluates, at full width
    (resnet50_voc, the main path's seeded weights, the eval_batched
    phase's 375x500 images with 2000 proposals): (1) per-pass against
    fused, (2) per-pass card against CPU, (3) the non-fused batched path,
    (4) UNION and aspect-ratio TTA, (5) RoIPool, (6) the dynamic int8 head.
    Returns {path: (RoIAlign forward launches, backward launches)}, each
    path's counted from 0 around its own run."""
    from cim_tpu_torch.engine.test import box_results_with_nms_and_limit
    from cim_tpu_torch.ops import quant
    from cim_tpu_torch.ops.roi_align import roi_pool

    t_phase = time.perf_counter()
    cfg = _smoke_cfg(data_dir, props)
    cfg.TEST.DATASETS = ("chip_smoke_batched",)
    roidb = get_roidb_and_dataset(cfg, cfg.TEST.DATASETS[0], props)[0]
    state = {k: v.detach() for k, v in model.state_dict().items()}
    passes = Evaluator.tta_pass_list(cfg)
    items = _eval_items(roidb, EVAL_BATCH)
    launches = {}

    def counted(path, fn, fwd):
        """fn() with the kernels' counts set to 0 just before and read just
        after: ``fwd`` forward launches and no backward one."""
        roi_align.kernel_launches = roi_align_backward.kernel_launches = 0
        out = fn()
        launches[path] = (roi_align.kernel_launches, roi_align_backward.kernel_launches)
        check(launches[path] == (fwd, 0),
              f"{path}: (forward, backward) launches {launches[path]}, want ({fwd}, 0)")
        return out

    # (1) per-pass against fused: float32, TF32 off, the shipped 10 passes
    cfg32 = clone_cfg(cfg)
    cfg32.TPU.PRECISION = "f32"
    m32 = build_model(cfg32, device="cuda")
    m32.load_state_dict(state)
    per32 = Evaluator(_per_pass_cfg(cfg32), m32, device="cuda")
    want = counted("eval_per_pass", lambda: [per32.im_detect_all(*it)
                                             for it in items[:PER_PASS_IMAGES]],
                   PER_PASS_IMAGES * len(passes))
    got = [Evaluator(cfg32, m32, device="cuda").im_detect_all(*it)
           for it in items[:PER_PASS_IMAGES]]
    corr = [float(np.corrcoef(g.ravel(), w.ravel())[0, 1]) for (g, _), (w, _) in zip(got, want)]
    dmax, dmean = _deviation([g for g, _ in got], [w for w, _ in want])
    log(f"[eval_paths] float32, {len(passes)} passes, {PER_PASS_IMAGES} images: fused vs "
        f"per-pass max_abs_err {dmax:.3g}, mean {dmean:.3g}, correlation "
        f"{[round(c, 7) for c in corr]} (cim_tpu's bound: rtol 5e-3, atol 5e-4, > 0.9999)")
    for (gs, gb), (ws, wb) in zip(got, want):
        check(gs.shape == ws.shape == (N_PROPS, cfg.MODEL.NUM_CLASSES) and np.array_equal(gb, wb),
              "per-pass and fused: shapes and boxes")
        np.testing.assert_allclose(gs, ws, **FUSED_TOL)
    check(min(corr) > 0.9999, "per-pass and fused scores correlate")

    # (2) per-pass, card against CPU: one pass (TTA off), float32
    one = _per_pass_cfg(cfg32, ENABLED=False)
    sub = (items[0][0], items[0][1][:CPU_PER_PASS_PROPS], items[0][2][:CPU_PER_PASS_PROPS])
    s_card, _ = Evaluator(one, m32, device="cuda").im_detect_all(*sub)
    m_cpu = build_model(one, device="cpu")
    m_cpu.load_state_dict({k: v.cpu() for k, v in state.items()})
    t0 = time.perf_counter()
    s_cpu, _ = Evaluator(one, m_cpu, device="cpu").im_detect_all(*sub)
    cpu_s = time.perf_counter() - t0
    del m_cpu
    log(f"[eval_paths] float32 one pass at scale {one.TEST.SCALE}, {CPU_PER_PASS_PROPS} "
        f"proposals: card vs CPU max_abs_err {np.abs(s_card - s_cpu).max():.3g} (scores up "
        f"to {s_cpu.max():.3g}; the CPU's pass {cpu_s:.1f} s; bound rtol 2e-3, atol 2e-5)")
    np.testing.assert_allclose(s_card, s_cpu, rtol=2e-3, atol=2e-5)

    # (3) non-fused batched against per-pass: one window of EVAL_BATCH
    # images; their 10 passes fall in 5 buckets (a scale and its hflip),
    # each 16 passes, so 10 stacks of 8
    nf32 = BatchedEvaluator(_per_pass_cfg(cfg32), m32, EVAL_BATCH, device="cuda")
    stacked = counted("eval_nonfused_batched", lambda: nf32.im_detect_all_many(items),
                      len(passes))
    single = [per32.im_detect_all(*it) for it in items]
    dmax, dmean = _deviation([g for g, _ in stacked], [w for w, _ in single])
    ratio = max(float((np.abs(g - w) / (BATCHED_TOL["atol"] + BATCHED_TOL["rtol"] * np.abs(w)))
                      .max()) for (g, _), (w, _) in zip(stacked, single))
    log(f"[eval_paths] float32 non-fused batched (stacks of {EVAL_BATCH} passes) vs per-pass, "
        f"{EVAL_BATCH} images: max_abs_err {dmax:.3g}, mean {dmean:.3g}, the worst element at "
        f"{ratio:.3g} of cim_tpu's bound (rtol 1e-5, atol 1e-7)")
    for (g, gb), (w, wb), it in zip(stacked, single, items):
        check(np.array_equal(gb, it[1]) and np.array_equal(wb, it[1]), "non-fused: boxes")
        np.testing.assert_allclose(g, w, **BATCHED_TOL)
    del per32, nf32, m32
    torch.cuda.empty_cache()

    # bf16, the shipped precision: per-pass s/image; non-fused batched
    # beside fused at EVAL_BATCH 8 on the same images
    per_bf = _TimedEvaluator(_per_pass_cfg(cfg), model)
    per_bf.im_detect_all(*items[-1])  # warm
    per_bf.seconds.clear()
    for it in items[:PER_PASS_IMAGES]:
        per_bf.im_detect_all(*it)
    stack_s = {}
    for name, c in (("non-fused", _per_pass_cfg(cfg)), ("fused", cfg)):
        c = clone_cfg(c)
        c.TPU.EVAL_BATCH = EVAL_BATCH
        ev = _TimedBatchedEvaluator(c, model)
        ev.im_detect_all_many(items)  # warm: cuDNN's choices at the stack
        ev.seconds.clear()
        ev.im_detect_all_many(items)
        stack_s[name] = ev.per_image()
    log(f"[eval_paths] {card}: bf16 s/image: per-pass Evaluator {np.median(per_bf.seconds):.4f} "
        f"(each {[round(s, 4) for s in per_bf.seconds]}; {len(passes)} host resizes and "
        f"uploads an image); a window of {EVAL_BATCH}: non-fused batched "
        f"{stack_s['non-fused']:.4f}, fused {stack_s['fused']:.4f}")
    if profile:
        phase_profile(per_bf, roidb[1], tag="one per-pass image")
    del per_bf

    # (4) UNION, and aspect-ratio passes with their hflip (cim_tpu's
    # default heuristics): each N-row block is its pass's own call
    with _deterministic_cudnn():
        for path, aug in (("eval_union", dict(SCORE_HEUR="UNION", COORD_HEUR="UNION")),
                          ("eval_aspect_ratio", dict(SCORE_HEUR="UNION", COORD_HEUR="UNION",
                                                     ASPECT_RATIOS=(0.75,),
                                                     ASPECT_RATIO_H_FLIP=True))):
            c = _per_pass_cfg(cfg, **aug)
            ev = Evaluator(c, model, device="cuda")
            m = len(passes) + 2 * len(c.TEST.BBOX_AUG.ASPECT_RATIOS)
            scores, bx = counted(path, lambda: ev.im_detect_all(*items[1]), m)
            n = len(items[1][1])
            check(scores.shape == (m * n, cfg.MODEL.NUM_CLASSES) and bx.shape == (m * n, 4)
                  and np.array_equal(bx, np.vstack([items[1][1]] * m)),
                  f"{path}: shapes {scores.shape}, {bx.shape} for {m} passes of {n}")
            own = [ev.im_detect_bbox(*inputs)[0] for inputs in ev.iter_tta_inputs(*items[1])]
            # the aspect passes sit before identity; also by their own entry point
            own_ar = [ev.im_detect_bbox_aspect_ratio(*items[1], r, hflip=f)[0]
                      for r in c.TEST.BBOX_AUG.ASPECT_RATIOS for f in (False, True)]
            check(len(own) == m and all(np.allclose(a, b, rtol=1e-6, atol=0)
                                        for a, b in zip(own[len(passes) - 1: -1], own_ar)),
                  f"{path}: the aspect passes by either entry point")
            worst = max(float(np.abs(scores[k * n: (k + 1) * n] - block).max())
                        for k, block in enumerate(own))
            for k, block in enumerate(own):
                np.testing.assert_allclose(scores[k * n: (k + 1) * n], block, rtol=1e-6, atol=0)
            s_nms, b_nms, _ = box_results_with_nms_and_limit(c, scores, bx)
            check(len(s_nms) > 0 and np.isfinite(s_nms).all() and np.isfinite(b_nms).all(),
                  f"{path}: NMS output finite")
            log(f"[eval_paths] {path}: {m} passes, scores {scores.shape}, boxes {bx.shape}; "
                f"each block against its pass's own call max_abs_err {worst:.3g} (bound rtol "
                f"1e-6, cuDNN deterministic); {len(s_nms)} detections after NMS")

    # (5) RoIPool (RoIPoolF), plain PyTorch: the card against the CPU at the
    # 1200 pass's map, then eval and a train step through it
    rng = np.random.RandomState(SEED + 11)
    feat, rois = _roi_case(rng, EVAL_FEAT, EVAL_VALID, 1 / 16, 2048, torch.bfloat16)
    with torch.no_grad():
        out = roi_pool(feat, rois, 7, 1 / 16, valid_hw=EVAL_VALID)
        t0 = time.perf_counter()
        ref = roi_pool(feat.cpu(), rois.cpu(), 7, 1 / 16, valid_hw=EVAL_VALID)
        cpu_s = time.perf_counter() - t0
        check(torch.equal(out.cpu(), ref) and (ref != 0).any(), "roi_pool: card bit-equal to CPU")
        pool_ms = cuda_ms(lambda: roi_pool(feat, rois, 7, 1 / 16, valid_hw=EVAL_VALID), 5)
        align_ms = cuda_ms(lambda: roi_align(feat, rois, 7, 1 / 16, 0, 4, EVAL_VALID), 20)
    log(f"[eval_paths] {card}: roi_pool at {EVAL_FEAT} bf16, valid {EVAL_VALID}, N 2048: "
        f"bit-equal to the CPU's ({cpu_s:.1f} s there); {pool_ms:.3f} ms on the card (plain "
        f"PyTorch), the RoIAlign kernel {align_ms:.4f} ms on the same input")
    del feat, rois, out, ref
    cfg_rp = clone_cfg(cfg)
    cfg_rp.FAST_RCNN.ROI_XFORM_METHOD = "RoIPoolF"
    m_rp = build_model(cfg_rp, device="cuda")
    m_rp.load_state_dict(state)
    ev_rp = _TimedEvaluator(cfg_rp, m_rp)
    ev_rp.im_detect_all(*items[2])  # warm
    s_rp, _ = counted("eval_roipool", lambda: ev_rp.im_detect_all(*items[3]), 0)
    check(s_rp.shape == (N_PROPS, cfg.MODEL.NUM_CLASSES) and np.isfinite(s_rp).all()
          and s_rp.std() > 0, "RoIPoolF eval: scores finite, not constant")
    rp_eval_s = ev_rp.seconds[-1]
    del m_rp, ev_rp
    tcfg = _train_cfg()
    tcfg.FAST_RCNN.ROI_XFORM_METHOD = "RoIPoolF"
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    trainer = Trainer(tcfg, device="cuda", seed=SEED, init_generator=gen)
    _randomize_frozen_bn(trainer.model, gen)
    batch = _train_batch(tcfg, np.random.RandomState(SEED + 12), TRAIN_SCALES[0],
                         TRAIN_N_VALID[0])
    body = [p for n, p in trainer.model.named_parameters()
            if n.startswith("Conv_Body.") and p.requires_grad]
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    (step_s, metrics), = _timed_steps(trainer, batch, 1)
    launches["train_roipool"] = (roi_align.kernel_launches, roi_align_backward.kernel_launches)
    _record_nms("train_roipool", tcfg.TPU.GRAD_ACCUM)
    rp_peak = torch.cuda.max_memory_allocated() / 1e9
    check(launches["train_roipool"] == (0, 0), "RoIPoolF train: no RoIAlign kernel")
    check(all(np.isfinite(v) for v in metrics.values()), f"RoIPoolF train: finite losses {metrics}")
    # the step's gradients stay in .grad until the next step zeroes them
    nonzero = sum(p.grad is not None and bool(p.grad.abs().max() > 0) for p in body)
    check(nonzero > 0, "RoIPoolF train: a non-zero gradient into Conv_Body")
    log(f"[eval_paths] {card}: RoIPoolF eval {rp_eval_s:.4f} s/image (fused, {len(passes)} "
        f"passes); one Trainer.step (scale {TRAIN_SCALES[0]}, 2000 proposals, GRAD_ACCUM "
        f"{tcfg.TPU.GRAD_ACCUM}) {step_s:.4f} s, peak {rp_peak:.2f} GB, total_loss "
        f"{metrics['total_loss']:.4f}, a non-zero gradient in {nonzero} of {len(body)} "
        f"trainable Conv_Body tensors")
    del trainer, batch, body
    torch.cuda.empty_cache()

    # (6) the dynamic int8 head. (a) Its products at MaskFuse's shapes on
    # the card against the port's CPU functions on the same float32 inputs:
    # the CPU recomputes the first CPU_ROWS rows (a row's scales and sums
    # are its own), which must match to the bit
    c = model.Box_Head.mask_branch[0].out_channels
    k_fc = model.Box_Head.seg_fc[0].in_features
    hidden = model.Box_Head.seg_fc[0].out_features
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    x = randn(2048, 7, 7, 2 * c)
    w, b = randn(c, 2 * c, 3, 3, scale=0.01), randn(c, scale=0.1)
    xd, wd, bd = randn(2048, k_fc), randn(hidden, k_fc, scale=0.005), randn(hidden, scale=0.1)
    for name, accs, fn, args in (
            ("int8_conv_nhwc", quant.conv_accumulators, quant.int8_conv_nhwc, (x, w, b)),
            ("int8_dense", quant.dense_accumulators, quant.int8_dense, (xd, wd, bd))):
        acc = accs(*args[:2])[0]
        host = [args[0][:CPU_ROWS].cpu()] + [a.cpu() for a in args[1:]]
        acc_cpu = accs(*host[:2])[0]
        check(torch.equal(acc[:CPU_ROWS].cpu(), acc_cpu), f"{name}: int32 accumulators bit-equal")
        check(_within_ulp(fn(*args)[:CPU_ROWS], fn(*host)), f"{name}: outputs within 1 ulp")
        log(f"[eval_paths] {name} at {tuple(args[0].shape)} x {tuple(args[1].shape)}: the "
            f"card's int32 accumulators of the first {CPU_ROWS} rows bit-equal to the CPU's, "
            f"outputs within 1 ulp")
        del acc, acc_cpu, host
    # (b) one-call times: the int8 forms against the bf16 calls the model
    # makes (its Conv2d / Linear cast the float32 weight each call)
    import torch.nn.functional as F

    xb, xdb = x.to(torch.bfloat16), xd.to(torch.bfloat16)
    rows, tap = torch.randint(-127, 128, (2048 * 49, 2 * c), dtype=torch.int8, device="cuda"), \
        torch.randint(-127, 128, (c, 2 * c), dtype=torch.int8, device="cuda")
    rows_d, w_q = torch.randint(-127, 128, (2048, k_fc), dtype=torch.int8, device="cuda"), \
        torch.randint(-127, 128, (hidden, k_fc), dtype=torch.int8, device="cuda")
    times = {
        "conv int8": cuda_ms(lambda: quant.int8_conv_nhwc(xb, w, b), 10),
        "conv int8 GEMM x9": 9 * cuda_ms(lambda: torch._int_mm(rows, tap.t()), 10),
        "conv bf16": cuda_ms(lambda: F.conv2d(xb.permute(0, 3, 1, 2), w.to(torch.bfloat16),
                                              b.to(torch.bfloat16), padding=1), 10),
        "fc int8": cuda_ms(lambda: quant.int8_dense(xdb, wd, bd), 10),
        "fc int8 GEMM": cuda_ms(lambda: torch._int_mm(rows_d, w_q.t()), 10),
        "fc bf16": cuda_ms(lambda: F.linear(xdb, wd.to(torch.bfloat16), bd.to(torch.bfloat16)),
                           10),
    }
    conv_ops = 2.0 * 2048 * 49 * 9 * 2 * c * c
    fc_ops = 2.0 * 2048 * k_fc * hidden
    bounds = {
        "conv int8": bound(xb.numel() * 2 + w.numel() * 4 + 2048 * 49 * c * 4, conv_ops,
                           torch.int8),
        "conv bf16": bound(xb.numel() * 2 + w.numel() * 4 + 2048 * 49 * c * 2, conv_ops,
                           torch.bfloat16),
        "fc int8": bound(xdb.numel() * 2 + wd.numel() * 4 + 2048 * hidden * 4, fc_ops, torch.int8),
        "fc bf16": bound(xdb.numel() * 2 + wd.numel() * 4 + 2048 * hidden * 2, fc_ops,
                         torch.bfloat16),
    }
    log(f"[eval_paths] {card}: one call, N 2048 ROIs, ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
        + "; bounds " + ", ".join(f"{k} {v[0]:.4f} by {v[1]}" for k, v in bounds.items())
        + f"; int8 / bf16: conv {times['conv int8'] / times['conv bf16']:.3f}, fc "
        f"{times['fc int8'] / times['fc bf16']:.3f}")
    del x, w, b, xd, wd, bd, xb, xdb, rows, tap, rows_d, w_q
    torch.cuda.empty_cache()

    # (c) TPU.EVAL_INT8 at EVAL_BATCH 8 over N_BATCHED_IMAGES images against
    # bf16 on the same images; (d) its peak memory
    items16 = _eval_items(roidb, N_BATCHED_IMAGES)
    runs = {}
    for name, int8 in (("bf16", False), ("int8", True)):
        c8 = clone_cfg(cfg)
        c8.TPU.EVAL_BATCH = EVAL_BATCH
        c8.TPU.EVAL_INT8 = int8
        ev = _TimedBatchedEvaluator(c8, model)
        ev.im_detect_all_many(items16[:EVAL_BATCH])  # warm
        ev.seconds.clear()
        torch.cuda.reset_peak_memory_stats()
        calls = quant.int_mm.calls
        res = counted(f"eval_{name}", lambda: ev.im_detect_all_many(items16),
                      len(passes) * N_BATCHED_IMAGES // EVAL_BATCH)
        runs[name] = (res, ev.per_image(), torch.cuda.max_memory_allocated() / 1e9,
                      quant.int_mm.calls - calls)
        if int8 and profile:
            phase_profile_batched(ev, roidb[:EVAL_BATCH], tag="int8: one stack")
        del ev
    (bf, bf_s, bf_peak, _), (i8, i8_s, i8_peak, mm_calls) = runs["bf16"], runs["int8"]
    launches.pop("eval_bf16")
    check(mm_calls == len(passes) * N_BATCHED_IMAGES // EVAL_BATCH * 10,
          f"int8 eval: {mm_calls} int8 products (9 conv taps and seg_fc.0 a pass of a stack)")
    dmax, dmean = _deviation([s for s, _ in i8], [s for s, _ in bf])
    for s, _ in i8:
        check(s.shape == (N_PROPS, cfg.MODEL.NUM_CLASSES) and np.isfinite(s).all()
              and s.min() >= 0.0 and s.max() <= 1.0, "int8 eval: scores finite in [0, 1]")
    log(f"[eval_paths] {card}: EVAL_BATCH {EVAL_BATCH}, {N_BATCHED_IMAGES} images: TPU.EVAL_INT8 "
        f"{i8_s:.4f} s/image, peak {i8_peak:.2f} GB, {mm_calls} int8 products; bf16 {bf_s:.4f} "
        f"s/image, peak {bf_peak:.2f} GB; int8 vs bf16 scores max_abs_err {dmax:.4g}, mean "
        f"{dmean:.4g} (cim_tpu's bound: max < {INT8_MAX_DEV}, mean < {INT8_MEAN_DEV})")
    check(dmax < INT8_MAX_DEV and dmean < INT8_MEAN_DEV, "int8 scores within cim_tpu's bound")
    log(f"[eval_paths] phase {time.perf_counter() - t_phase:.1f} s; RoIAlign (forward, "
        f"backward) launches by path {launches}")
    return launches


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
    nms_kernel = phase_nms()
    fwd_kernel = phase_roi_align()
    bwd_kernel = phase_roi_align_bwd()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work_dir:
        eval_launches, evaluator, roidb = phase_main_path(work_dir, card)
        if args.profile:
            phase_profile(evaluator, roidb[1])
        batched_launches, batched_dir, batched_props = phase_eval_batched(
            work_dir, card, evaluator.model, profile=args.profile)
        paths = phase_eval_paths(card, evaluator.model, batched_dir, batched_props,
                                 profile=args.profile)
        del evaluator
        phase_train_reference()
        train_fwd, train_bwd = phase_train(card, work_dir, profile=args.profile)
        horizon = phase_horizon(work_dir, card)
        cli_fwd, cli_bwd, cli_paths, cli_ckpt, cli = phase_train_cli(work_dir, card,
                                                                     profile=args.profile)
        ddp_fwd, ddp_bwd, gloo2_fwd, gloo2_bwd = phase_ddp(work_dir, card, cli)
        roi_align.kernel_launches = 0
        roi_align_backward.kernel_launches = 0
        eval_cli_fwd = phase_eval_cli(work_dir, card, cli_paths, cli_ckpt)
        eval_cli_bwd = roi_align_backward.kernel_launches
        # PyTorch's default cuDNN flag (TF32 allowed), as a user's process runs the
        # preprocessing: the PRM classes turn TF32 off for their own calls
        torch.backends.cudnn.allow_tf32 = True
        try:
            pre_fwd, pre_bwd = phase_preprocess(work_dir, card, cli_paths, profile=args.profile)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        bodies = {body: phase_body(body, card, batched_dir, batched_props, profile=args.profile)
                  for body in BODIES}
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")

    print(card)
    print(json.dumps({"kernels": [
        {
            "name": "roi_align_fwd",
            "route": "cuda",
            "source": "cim_tpu_torch/csrc/roi_align_fwd.cu",
            "replaces": "cim_tpu/ops/pallas/roi_align_kernel.py:151",
            "launches": train_fwd,
            "launches_by_path": {"eval": eval_launches, "eval_batched": batched_launches,
                                 "train": train_fwd, "train_cli": cli_fwd,
                                 "train_ddp": ddp_fwd, "train_ddp_gloo2": gloo2_fwd,
                                 "eval_cli": eval_cli_fwd, "train_cli_pre": pre_fwd,
                                 **{p: v[0] for p, v in paths.items()},
                                 **{p: v[0] for p, v in horizon.items()},
                                 **{f"eval_{b}": v[0] for b, v in bodies.items()},
                                 **{f"train_{b}": v[1] for b, v in bodies.items()}},
            **fwd_kernel,
        },
        {
            "name": "roi_align_bwd",
            "route": "cuda",
            "source": "cim_tpu_torch/csrc/roi_align_bwd.cu",
            "replaces": "cim_tpu/ops/pallas/roi_align_kernel.py:169",
            "launches": train_bwd,
            "launches_by_path": {"eval": 0, "eval_batched": 0, "train": train_bwd,
                                 "train_cli": cli_bwd, "train_ddp": ddp_bwd,
                                 "train_ddp_gloo2": gloo2_bwd, "eval_cli": eval_cli_bwd,
                                 "train_cli_pre": pre_bwd,
                                 **{p: v[1] for p, v in paths.items()},
                                 **{p: v[1] for p, v in horizon.items()},
                                 **{f"eval_{b}": 0 for b in bodies},
                                 **{f"train_{b}": v[2] for b, v in bodies.items()}},
            **bwd_kernel,
        },
        {
            "name": "nms_from_iou",
            "route": "cuda",
            "source": "cim_tpu_torch/csrc/nms_from_iou.cu",
            "replaces": None,
            "launches": NMS_LAUNCHES["train"],
            # counted in each path's run: 3 a mined microbatch, as a graph
            # replay launches them or op by op
            "launches_by_path": dict(NMS_LAUNCHES),
            **nms_kernel,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
