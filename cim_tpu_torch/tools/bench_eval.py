"""TTA inference throughput benchmark on one CUDA card (port of
tools/bench_eval.py).

    python -m cim_tpu_torch.tools.bench_eval --modes seq,batched --eval_batch 8
    python -m cim_tpu_torch.tools.bench_eval --modes e2e --int8
    python -m cim_tpu_torch.tools.bench_eval --device cpu --n_images 2 \\
        --n_props 32 --set MODEL.CONV_BODY tiny.conv_body   # on the CPU

Measures s/image of the FULL 10-pass VOC TTA protocol (hflip + 4 scales x
hflip + identity, configs/resnet50_voc.yaml:42-52) at production shape
(375x500 images, --n_props COB-style proposals), with seeded random
weights: mode "seq" is the Evaluator, one image at a time after a warm
image; "batched" the BatchedEvaluator at --eval_batch after a warm stack.
Mode "e2e" times the whole test_net -> evaluation chain over an on-disk
synthetic set (JPEG decode, TTA, detections.pkl, NMS overlapped with the
card by _AsyncPost, COCO box eval, then the instance-seg tail: mask NMS,
RLE and COCOeval segm) after a warm pass, with its box AP and mAP50.
Prints one JSON line a mode. MFU is the analytic forward FLOPs of the 10
passes over the H100's dense bf16 peak (null on the CPU).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from cim_tpu_torch.config import cfg_from_list, clone_cfg, load_cfg
from cim_tpu_torch.engine.test import BatchedEvaluator, Evaluator
from cim_tpu_torch.models.builder import build_model
from cim_tpu_torch.tools.bench_train import PEAK_FLOPS, model_train_flops
from cim_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_e2e(cfg, model, args, device, log=print):
    """One wall clock over the whole test_net -> evaluation chain; returns
    the printed record."""
    from cim_tpu_torch.data import catalog
    from cim_tpu_torch.data.synthetic import write_synthetic_coco_dataset
    from cim_tpu_torch.engine.test_engine import post_process_results, test_net
    from cim_tpu_torch.evaluation import task_evaluation
    from cim_tpu_torch.tools.evaluation import coco_inst_seg_eval, eval_shard

    with tempfile.TemporaryDirectory(prefix="bench_e2e_") as data_dir:
        # real JPEGs (their decode is part of the measured chain), a COCO json
        # with 2 gt an image and the proposal pickle
        write_synthetic_coco_dataset(data_dir, args.n_images, args.n_props,
                                     np.random.RandomState(0), image_hw=(375, 500),
                                     write_jpegs=True)
        catalog.register_dataset("bench_e2e", {
            catalog.IM_DIR: data_dir,
            catalog.ANN_FN: os.path.join(data_dir, "ann.json"),
        })
        cfg.TEST.DATASETS = ("bench_e2e",)
        # the gt roidb cache is keyed by the dataset's name alone: keep it in
        # this run's directory, so that no later run reads these image paths
        cfg.DATA_DIR = data_dir
        cfg.TPU.EVAL_BATCH = args.eval_batch
        props = os.path.join(data_dir, "props.pkl")
        out_dir = os.path.join(data_dir, "out")
        # a warm pass with a shared evaluator: cuDNN's algorithm search and the
        # allocator's first blocks are one-time costs, which the reference
        # spreads over its ~5k test images (lib/core/test_engine.py:269-310)
        evaluator = (BatchedEvaluator(cfg, model, args.eval_batch, device=device)
                     if args.eval_batch > 1 else Evaluator(cfg, model, device=device))
        tw = time.time()
        test_net(cfg, model, "bench_e2e", props, out_dir + "_warm", evaluator=evaluator,
                 device=device)
        t_warmup_total = time.time() - tw
        t0 = time.time()
        all_scores, roidb, dataset = test_net(cfg, model, "bench_e2e", props, out_dir,
                                              evaluator=evaluator, device=device)
        t_detect = time.time() - t0
        all_boxes = post_process_results(cfg, all_scores, roidb, dataset)
        box_metrics = task_evaluation.evaluate_all(dataset, all_boxes, out_dir)
        t_boxeval = time.time() - t0 - t_detect

        opts = {
            "num_classes": cfg.MODEL.NUM_CLASSES,
            "score_thresh": cfg.TEST.SCORE_THRESH,
            "nms": cfg.TEST.NMS,
            "proposal_filter": True,
            "detections_per_im": cfg.TEST.DETECTIONS_PER_IM,
            "coco_scheme": False,
        }
        cat_ids = sorted(dataset.COCO.getCatIds())
        detections = {k: {"scores": v["scores"], "boxes": v["boxes"]}
                      for k, v in all_scores.items()}
        seg_results = eval_shard((opts, roidb, detections, None, cat_ids))
        seg_metrics = coco_inst_seg_eval(dataset.COCO, seg_results)
        total = time.time() - t0
        t_segeval = total - t_detect - t_boxeval

    n_passes = len(Evaluator.tta_pass_list(cfg))
    rec = {
        "metric": "eval_pipeline_images_per_sec_e2e",
        "value": round(args.n_images / total, 3),
        "unit": "images/sec",
        "device": _device_name(device),
        "images": args.n_images,
        "passes": n_passes,
        "eval_batch": args.eval_batch,
        "s_per_image_e2e": round(total / args.n_images, 3),
        "one_time_warmup_s": round(t_warmup_total - total, 3),
        "breakdown_s_per_image": {
            "tta_detect_incl_overlapped_nms": round(t_detect / args.n_images, 3),
            "box_eval": round(t_boxeval / args.n_images, 3),
            "inst_seg_eval": round(t_segeval / args.n_images, 3),
        },
        "box_AP": float(box_metrics.get("AP", -1)),
        "inst_seg_mAP50": float(seg_metrics.get("mAP50", -1)),
        "seg_results": len(seg_results),
    }
    log(json.dumps(rec))
    return rec


def _device_name(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def make_item(seed, n_props):
    """A VOC-typical 375x500 uint8 image with n_props boxes and 7x7 masks."""
    r = np.random.RandomState(seed)
    im = (r.rand(375, 500, 3) * 255).astype(np.uint8)
    x1 = r.uniform(0, 250, n_props)
    y1 = r.uniform(0, 180, n_props)
    boxes = np.stack(
        [x1, y1, x1 + r.uniform(16, 249, n_props), y1 + r.uniform(16, 194, n_props)], -1,
    ).astype(np.float32)
    masks = (r.rand(n_props, 7, 7) > 0.5).astype(np.float32)
    return im, boxes, masks


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n_images", type=int, default=8)
    ap.add_argument("--n_props", type=int, default=1900)
    ap.add_argument("--eval_batch", type=int, default=4)
    ap.add_argument("--modes", default="seq,batched", help="seq, batched and/or e2e")
    ap.add_argument("--cfg", default=os.path.join(REPO, "configs", "resnet50_voc.yaml"))
    ap.add_argument("--int8", action="store_true",
                    help="TPU.EVAL_INT8: dynamic w8a8 MaskFuse conv and fc1")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--set", dest="set_cfgs", nargs="+", default=None,
                    help="config key-value pairs, applied after the yaml")
    return ap.parse_args(argv)


def main(argv=None, log=print):
    """Run the modes; returns {mode: its printed record}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = clone_cfg(load_cfg(args.cfg))
    if args.set_cfgs:
        cfg_from_list(cfg, args.set_cfgs)
    cfg.TPU.DATA_PARALLEL = 1
    cfg.TPU.PALLAS_ROI_ALIGN = True  # the kernel's grid cap (4)
    if args.int8:
        cfg.TPU.EVAL_INT8 = True
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(0))
    modes = args.modes.split(",")
    records = {}
    if "e2e" in modes:
        records["e2e"] = run_e2e(cfg, model, args, device, log)

    items = [make_item(i, args.n_props) for i in range(args.n_images)]
    # analytic forward FLOPs of the TTA protocol for one image: the train
    # FLOP model (fwd + bwd = 3x fwd) divided back to the forward, summed
    # over the passes' canvas-dependent feature shapes
    rh, rw = Evaluator._ratio_bucket(375, 500)
    flops = sum(
        model_train_flops(
            args.n_props,
            (-(-int(np.ceil(t * rh)) // 16), -(-int(np.ceil(t * rw)) // 16)),
            num_classes=cfg.MODEL.NUM_CLASSES, refine_times=cfg.REFINE_TIMES,
        ) / 3.0
        for t, _ in Evaluator.tta_pass_list(cfg)
    )
    n_passes = len(Evaluator.tta_pass_list(cfg))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def record(metric, dt, **extra):
        rec = {"metric": metric, "value": round(dt, 4), "unit": "s/image",
               "device": _device_name(device), "passes": n_passes, **extra,
               "mfu_model": round(flops / dt / PEAK_FLOPS, 4) if device.type == "cuda" else None}
        log(json.dumps(rec))
        return rec

    if "seq" in modes:
        ev = Evaluator(cfg, model, device=device)
        ev.im_detect_all(*items[0])  # warm: every pass's shapes
        sync()
        t0 = time.time()
        for it in items:
            ev.im_detect_all(*it)  # each ends in the scores' copy to the host
        records["seq"] = record("tta_eval_s_per_image_sequential",
                                (time.time() - t0) / len(items))
    if "batched" in modes:
        bev = BatchedEvaluator(cfg, model, args.eval_batch, device=device)
        bev.im_detect_all_many(items[: args.eval_batch])  # warm: the stack's shapes
        sync()
        t0 = time.time()
        bev.im_detect_all_many(items)
        records["batched"] = record("tta_eval_s_per_image_batched",
                                    (time.time() - t0) / len(items),
                                    eval_batch=args.eval_batch)
    return records


if __name__ == "__main__":
    main()
