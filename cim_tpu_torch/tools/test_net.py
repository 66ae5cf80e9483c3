"""Inference and detection-evaluation CLI on CUDA cards (port of
tools/test_net.py).

    python -m cim_tpu_torch.tools.test_net --cfg configs/resnet50_voc.yaml \\
        --load_ckpt Outputs/resnet50_voc/<run>/ckpt --dataset voc2012sbdval
    python -m cim_tpu_torch.tools.test_net --device cpu --cfg configs/resnet50_voc.yaml \\
        --set MODEL.CONV_BODY tiny.conv_body ...   # on the CPU, the tiny body

Runs the TTA evaluator over the test set (or the train set, for CorLoc),
writes detections.pkl (discovery.pkl with --corloc), post-processes each
image (NMS and limit, or the CorLoc argmax) and evaluates, as cim_tpu's
CLI does: the same flags, dataset presets, outputs and EXPECTED_RESULTS
gate (a failed gate raises, so the command exits non-zero). --range runs
one slice and writes its range pickle without evaluating; --multi_proc N
runs N such children and merges them here, one card each where there
are several. TPU.EVAL_DEVICES splits each batched stack over that many
cards of this process (-1: every visible card). --load_ckpt reads only the
model of a checkpoint of the training CLI (a directory: its latest step;
or one model_step<n>.pth), --wait first waits for one to appear.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from collections import defaultdict

from cim_tpu_torch.config import assert_and_infer_cfg, cfg_from_file, cfg_from_list, get_default_cfg
from cim_tpu_torch.engine.checkpoint import checkpoint_location, load_model_weights, wait_for_checkpoint
from cim_tpu_torch.engine.stats import Timer, setup_logging

logger = logging.getLogger("cim_tpu_torch.tools.test_net")


def parse_args(argv=None):
    # allow_abbrev=False: parent mode passes its own argv to the children
    # without --multi_proc, and an abbreviation (--multi 2) would survive
    parser = argparse.ArgumentParser(description="Test CIM (PyTorch, CUDA cards)",
                                     allow_abbrev=False)
    parser.add_argument("--dataset", help="voc2012sbdval | voc2012trainaug | coco2017val | "
                        "coco2017testdev")
    parser.add_argument("--cfg", dest="cfg_file", required=True)
    parser.add_argument("--set", dest="set_cfgs", nargs="+", default=None,
                        help="config key-value pairs")
    parser.add_argument("--load_ckpt",
                        help="a checkpoint directory (its latest step) or one model_step<n>.pth")
    parser.add_argument("--load_detectron", default=None,
                        help="Detectron-pkl weight file (reference tools/test_net.py:49-50)")
    parser.add_argument("--output_dir", default=None)
    parser.add_argument("--range", nargs=2, type=int, default=None,
                        help="start end image index range")
    parser.add_argument("--multi_proc", type=int, default=0,
                        help="parent mode: N child processes over contiguous --range shards, "
                        "merged here (reference multi_gpu_test_net_on_dataset)")
    parser.add_argument("--wait", action="store_true",
                        help="wait for the checkpoint to appear")
    parser.add_argument("--corloc", action="store_true",
                        help="train-set discovery protocol (CorLoc and discovery.pkl); implied "
                        "by --dataset voc2012trainaug")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler trace of the evaluator's calls after the "
                        "first there, the NMS worker's thread included")
    return parser.parse_args(argv)


def _configure(args):
    """(cfg, check_corloc): the yaml, then --set, then the dataset preset."""
    cfg = get_default_cfg()
    cfg_from_file(cfg, args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(cfg, args.set_cfgs)
    check_corloc = args.corloc
    if args.dataset == "voc2012sbdval":
        cfg.TEST.DATASETS = ("voc_2012_sbdval",)
        cfg.MODEL.NUM_CLASSES = 20
    elif args.dataset == "voc2012trainaug":
        cfg.TEST.DATASETS = ("voc_2012_trainaug",)
        cfg.MODEL.NUM_CLASSES = 20
        check_corloc = True  # train-set inference is the discovery protocol
    elif args.dataset == "coco2017val":
        cfg.TEST.DATASETS = ("coco_2017_val",)
        cfg.MODEL.NUM_CLASSES = 80
    elif args.dataset == "coco2017testdev":
        cfg.TEST.DATASETS = ("coco_2017_test-dev",)
        cfg.MODEL.NUM_CLASSES = 80
    elif args.dataset is not None:
        raise ValueError(f"Unexpected args.dataset: {args.dataset}")
    assert_and_infer_cfg(cfg, make_immutable=False)
    return cfg, check_corloc


def _child_argv(argv, output_dir, add_output_dir):
    """The parent's arguments without --multi_proc, with the output
    directory the parent merges from."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--multi_proc":
            skip = True
        elif not a.startswith("--multi_proc="):
            out.append(a)
    return out + (["--output_dir", output_dir] if add_output_dir else [])


def main(argv=None):
    """Run the CLI. Returns {"results", "all_boxes", "all_scores" (the
    records, with their post-processed detections where this process made
    them), "output_dir", "det_file", "step" (the checkpoint's, or None),
    "model" (None in parent mode), "seconds": {"load", "evaluator",
    "inference"}}: host time
    to build the model and load its weights, the evaluator's calls, and
    run_inference whole (the rest of it: reading the images, writing the
    pickle, post-processing and evaluation)."""
    setup_logging()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    cfg, check_corloc = _configure(args)
    output_dir = args.output_dir or os.path.join(
        cfg.OUTPUT_DIR, os.path.splitext(os.path.basename(args.cfg_file))[0], "test")
    det_file = os.path.join(output_dir, ("discovery" if check_corloc else "detections") + ".pkl")
    summary = {"output_dir": output_dir, "det_file": det_file, "step": None, "model": None,
               "results": None, "all_boxes": None, "all_scores": None, "seconds": {}}

    if args.multi_proc > 1 and args.range is None:
        # parent mode: no model here; the children do the device work
        from cim_tpu_torch.engine.test_engine import multi_process_inference

        os.makedirs(output_dir, exist_ok=True)
        t0 = time.perf_counter()
        results, all_boxes, all_scores = multi_process_inference(
            cfg, _child_argv(argv, output_dir, args.output_dir is None), args.multi_proc,
            output_dir, check_corloc=check_corloc, check_expected_results=True)
        summary["seconds"]["inference"] = time.perf_counter() - t0
        logger.info("Results: %s", {k: v for k, v in results.items() if k != "per_class"})
        summary.update(results=results, all_boxes=all_boxes, all_scores=all_scores)
        return summary

    from cim_tpu_torch.engine.test_engine import run_inference
    from cim_tpu_torch.models.builder import build_model
    from cim_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    model = build_model(cfg, device=device)
    if args.load_ckpt:
        ckpt_dir, step = checkpoint_location(args.load_ckpt)
        if args.wait:
            wait_for_checkpoint(ckpt_dir)
        summary["step"] = load_model_weights(ckpt_dir, model, step)
        logger.info("Loaded checkpoint at step %d", summary["step"])
    elif args.load_detectron:
        from cim_tpu_torch.utils.detectron_weights import load_detectron_pkl

        model.load_state_dict(load_detectron_pkl(args.load_detectron), strict=True)
        logger.info("Loaded Detectron pkl weights from %s", args.load_detectron)
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)
    summary["seconds"]["load"] = time.perf_counter() - t0

    timers = defaultdict(Timer)
    t0 = time.perf_counter()
    results, all_boxes, all_scores = run_inference(
        cfg, model, output_dir, check_corloc=check_corloc, check_expected_results=True,
        ind_range=args.range, device=device, timers=timers, profile_dir=args.profile_dir)
    summary["seconds"]["inference"] = time.perf_counter() - t0
    summary["seconds"]["evaluator"] = timers["im_detect_bbox"].total_time
    if args.range:
        summary["det_file"] = det_file[:-4] + f"_range_{args.range[0]}_{args.range[1]}.pkl"
    if results is not None:
        logger.info("Results: %s", {k: v for k, v in results.items() if k != "per_class"})
    summary.update(results=results, all_boxes=all_boxes, all_scores=all_scores, model=model)
    return summary


if __name__ == "__main__":
    main()
