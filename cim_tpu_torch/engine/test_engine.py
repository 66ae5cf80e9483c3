"""Inference loop: dataset -> fused TTA -> detections -> NMS -> evaluation
(port of cim_tpu/engine/test_engine.py, single process).

Behaviour contracts (reference lib/core/test_engine.py): test_net loops
the roidb calling im_detect_all and pickles {image: {scores, boxes}} as
detections.pkl (val) or discovery.pkl (train CorLoc); run_inference then
applies box_results_with_nms_and_limit (or box_results_for_corloc) per
image and calls task_evaluation.evaluate_all. The dataset, roidb and
metric code are the port's copies of cim_tpu's host modules. With
TPU.EVAL_BATCH > 1 (the shipped configs' 8) images go through the
cross-image BatchedEvaluator in windows of 4 x EVAL_BATCH. The host's
NMS and limit (or CorLoc argmax) of each image runs in one worker thread
(_AsyncPost) while the card runs the next images. multi_process_inference
is the reference's fan-out over child processes (the test_net CLI's
--multi_proc); with more than one visible card, child i sees card
i % n alone, as the reference's lib/utils/subprocess.py pins them.
TPU.EVAL_DEVICES splits each batched stack over cards (eval_devices).
"""
from __future__ import annotations

import logging
import os
from collections import defaultdict
from concurrent.futures import wait

import torch

from cim_tpu_torch.data.json_dataset import JsonDataset
from cim_tpu_torch.engine.stats import Timer
from cim_tpu_torch.engine.test import (
    BatchedEvaluator,
    Evaluator,
    box_results_for_corloc,
    box_results_with_nms_and_limit,
)
from cim_tpu_torch.utils.device import resolve_device
from cim_tpu_torch.utils.io import load_object, save_object
from cim_tpu_torch.utils.trace import Profile, span

logger = logging.getLogger(__name__)

PROFILE_IMAGES = 8  # images --profile_dir traces, in the evaluator's calls after the first


def get_roidb_and_dataset(cfg, dataset_name, proposal_file, ind_range=None):
    """(reference test_engine.get_roidb_and_dataset :359-392)."""
    dataset = JsonDataset(cfg, dataset_name)
    roidb = dataset.get_roidb(gt=True, proposal_file=proposal_file)
    total = len(roidb)
    start, end = (0, total) if ind_range is None else ind_range
    return roidb[start:end], dataset, start, end, total


def empty_results(num_classes, num_images):
    """all_boxes[cls][image] = N x 5 [x1, y1, x2, y2, score]."""
    return [[[] for _ in range(num_images)] for _ in range(num_classes + 1)]


def eval_devices(cfg, device: torch.device) -> list:
    """The devices TPU.EVAL_DEVICES asks for (cim_tpu
    engine/test_engine.py:127-147): -1 every visible card, n up to the
    visible count (above it cim_tpu's warning, and what there is), 1 the
    model's device alone. ``device`` first (cuda means cuda:0), then the
    other cards in order. The CPU counts as one device."""
    n = int(cfg.TPU.get("EVAL_DEVICES", 1) or 1)
    if n == 1:
        return [device]
    local = torch.cuda.device_count() if device.type == "cuda" else 1
    if n > local:
        logger.warning("TPU.EVAL_DEVICES=%d exceeds the %d local devices; using %d",
                       n, local, local)
    if device.type == "cpu":
        return [device]
    n = local if n < 0 else min(n, local)
    first = device.index or 0
    return [torch.device("cuda", first)] + [
        torch.device("cuda", i) for i in range(local) if i != first][: n - 1]


def _det_basename(check_corloc: bool) -> str:
    return "discovery" if check_corloc else "detections"


class _AsyncPost:
    """The host's NMS and limit (or CorLoc argmax) of each image in one
    worker thread, overlapping the card's work on the next images. Numpy
    and the C++ NMS, which releases the interpreter lock; the same
    functions as post_process_results, so the results are the same bits."""

    def __init__(self, cfg, check_corloc: bool):
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(max_workers=1)
        self._post = box_results_for_corloc if check_corloc else box_results_with_nms_and_limit
        self._cfg = cfg
        self._futures = {}

    def _one(self, scores, boxes):
        with span("cim.eval.post"):
            return self._post(self._cfg, scores, boxes)[2]

    def submit(self, key, scores, boxes):
        self._futures[key] = self._pool.submit(self._one, scores, boxes)

    def results(self) -> dict:
        try:
            return {k: f.result() for k, f in self._futures.items()}
        finally:
            self._pool.shutdown()


class _EvalProfile:
    """torch.profiler over test_net's evaluator calls from the second (the
    first builds and warms) until PROFILE_IMAGES images, every thread
    recorded, so that the trace also holds _AsyncPost's cim.eval.post
    spans. Before it stops, the post-processing submitted so far finishes."""

    def __init__(self, profile_dir, device, post):
        self.dir, self.device, self.post = profile_dir, device, post
        self.prof, self.images, self.calls = None, 0, 0

    def before_call(self):
        if self.dir and self.calls == 1:
            self.prof = Profile(self.dir, resolve_device(self.device), all_threads=True)
        self.calls += 1

    def after_call(self, n_images: int):
        if self.prof is not None:
            self.images += n_images
            if self.images >= PROFILE_IMAGES:
                self.stop()

    def stop(self):
        if self.prof is None:
            return
        if self.post is not None:
            wait(list(self.post._futures.values()))
        self.prof.stop(images=self.images)
        self.prof = None


def _cache_key(check_corloc: bool) -> str:
    return "_cls_boxes_corloc" if check_corloc else "_cls_boxes"


def _default_image_loader(entry):
    import cv2

    im = cv2.imread(entry["image"])
    if im is None:
        raise FileNotFoundError(f"cannot read {entry['image']}")
    return im


def test_net(
    cfg,
    model,
    dataset_name,
    proposal_file,
    output_dir,
    ind_range=None,
    check_corloc=False,
    image_loader=None,
    evaluator=None,
    device="cuda",
    timers=None,
    profile_dir=None,
):
    """Single-device dataset loop. model: a CIMModel on ``device`` (the
    card unless the caller passes device="cpu").
    image_loader(entry) -> (H, W, 3) uint8 BGR image (defaults to
    cv2.imread). evaluator: a prebuilt Evaluator (TPU.EVAL_BATCH 1) or
    BatchedEvaluator (above 1) to reuse. timers: a defaultdict(Timer)
    that receives the loop's timers ("im_detect_bbox": the evaluator's
    calls). Without ind_range each record also carries its post-processed
    detections (the _AsyncPost cache) after the pickle is written.
    profile_dir: write a torch.profiler trace of the evaluator's calls
    from the second on (PROFILE_IMAGES images) there."""
    roidb, dataset, start_ind, end_ind, total_num_images = get_roidb_and_dataset(
        cfg, dataset_name, proposal_file, ind_range
    )
    num_images = len(roidb)
    image_loader = image_loader or _default_image_loader
    timers = defaultdict(Timer) if timers is None else timers
    all_scores = {}
    # a --range child's records are post-processed by the parent, from the
    # range pickle, so it runs no worker
    post = _AsyncPost(cfg, check_corloc) if ind_range is None else None
    profile = _EvalProfile(profile_dir, device, post)
    eval_batch = int(cfg.TPU.EVAL_BATCH or 1)
    if eval_batch > 1:
        # cross-image batched TTA (engine.test.BatchedEvaluator), each
        # stack split over the TPU.EVAL_DEVICES cards
        if evaluator is None:
            devices = eval_devices(cfg, resolve_device(device))
            logger.info("eval devices: %s", [str(d) for d in devices])
            evaluator = BatchedEvaluator(cfg, model, eval_batch, devices=devices)
        window = 4 * evaluator.batch_size
        for w0 in range(0, num_images, window):
            chunk = roidb[w0: w0 + window]
            items = [(image_loader(e), e["boxes"], e["masks"]) for e in chunk]
            profile.before_call()
            timers["im_detect_bbox"].tic()
            results = evaluator.im_detect_all_many(items, window)
            timers["im_detect_bbox"].toc(average=False)
            for e, (scores, boxes) in zip(chunk, results):
                all_scores[e["image"]] = {"scores": scores, "boxes": boxes}
                if post is not None:
                    post.submit(e["image"], scores, boxes)
            profile.after_call(len(chunk))
            done = min(w0 + window, num_images)
            ave = timers["im_detect_bbox"].total_time / done
            logger.info(
                "im_detect: range [%d, %d] of %d: %d/%d %.3fs/im (eta: %ds)",
                start_ind + 1, end_ind, total_num_images, start_ind + done,
                start_ind + num_images, ave, int((num_images - done) * ave),
            )
    else:
        if int(cfg.TPU.get("EVAL_DEVICES", 1) or 1) != 1:
            logger.warning("TPU.EVAL_DEVICES has no effect with TPU.EVAL_BATCH <= 1; "
                           "running the sequential single-device evaluator")
        evaluator = evaluator or Evaluator(cfg, model, device=device)
        for i, entry in enumerate(roidb):
            im = image_loader(entry)
            profile.before_call()
            timers["im_detect_bbox"].tic()
            scores, boxes = evaluator.im_detect_all(im, entry["boxes"], entry["masks"])
            timers["im_detect_bbox"].toc()
            all_scores[entry["image"]] = {"scores": scores, "boxes": boxes}
            if post is not None:
                post.submit(entry["image"], scores, boxes)
            profile.after_call(1)
            if i % 10 == 0:
                ave = timers["im_detect_bbox"].average_time
                logger.info(
                    "im_detect: range [%d, %d] of %d: %d/%d %.3fs (eta: %ds)",
                    start_ind + 1, end_ind, total_num_images, start_ind + i + 1,
                    start_ind + num_images, ave, int((num_images - i - 1) * ave),
                )

    profile.stop()
    det_name = _det_basename(check_corloc) + ".pkl"
    if ind_range is not None:
        det_name = f"{det_name[:-4]}_range_{ind_range[0]}_{ind_range[1]}.pkl"
    det_file = os.path.join(output_dir, det_name)
    save_object(all_scores, det_file)
    logger.info("Wrote detections to: %s", os.path.abspath(det_file))
    # the worker's results join the records only now, so that the pickle
    # on disk stays {scores, boxes} (the reference's, test_engine.py:312-330)
    if post is not None:
        key = _cache_key(check_corloc)
        for image, cls_boxes in post.results().items():
            all_scores[image][key] = cls_boxes
    return all_scores, roidb, dataset


def post_process_results(cfg, all_scores, roidb, dataset, check_corloc=False):
    """Per-image NMS + limit (or CorLoc argmax) -> all_boxes
    (reference test_engine.py:188-197). A record's cached detections
    (test_net's _AsyncPost) are used as they are; records without them (a
    merged range pickle) are post-processed here, with the same functions."""
    all_boxes = empty_results(cfg.MODEL.NUM_CLASSES, len(roidb))
    post = box_results_for_corloc if check_corloc else box_results_with_nms_and_limit
    key = _cache_key(check_corloc)
    for i, entry in enumerate(roidb):
        rec = all_scores[entry["image"]]
        cls_boxes_i = rec.get(key)
        if cls_boxes_i is None:
            cls_boxes_i = post(cfg, rec["scores"], rec["boxes"])[2]
        for j in range(1, cfg.MODEL.NUM_CLASSES + 1):
            all_boxes[j][i] = cls_boxes_i[j]
    return all_boxes


def run_inference(
    cfg,
    model,
    output_dir,
    check_corloc=False,
    check_expected_results=False,
    image_loader=None,
    ind_range=None,
    evaluator=None,
    device="cuda",
    timers=None,
    profile_dir=None,
):
    """Top-level inference + evaluation (reference run_inference :90-151).
    With ind_range only that slice is processed and pickled, and
    evaluation is skipped. timers and profile_dir: as test_net's. Returns
    (results, all_boxes, all_scores)."""
    dataset_name = cfg.TEST.DATASETS[0]
    proposal_file = cfg.TEST.PROPOSAL_FILES[0] if cfg.TEST.PROPOSAL_FILES else None
    all_scores, roidb, dataset = test_net(
        cfg, model, dataset_name, proposal_file, output_dir,
        ind_range=tuple(ind_range) if ind_range else None,
        check_corloc=check_corloc, image_loader=image_loader,
        evaluator=evaluator, device=device, timers=timers, profile_dir=profile_dir,
    )
    if ind_range:
        return None, None, all_scores
    return _post_process_and_evaluate(
        cfg, all_scores, roidb, dataset, output_dir, check_corloc,
        check_expected_results,
    )


def _post_process_and_evaluate(cfg, all_scores, roidb, dataset, output_dir,
                               check_corloc, check_expected_results):
    """Per-image NMS/CorLoc post-processing, evaluate_all and the
    expected-results gate."""
    from cim_tpu_torch.evaluation import task_evaluation

    all_boxes = post_process_results(cfg, all_scores, roidb, dataset, check_corloc)
    results = task_evaluation.evaluate_all(
        dataset, all_boxes, output_dir, test_corloc=check_corloc
    )
    if check_expected_results and cfg.EXPECTED_RESULTS:
        failures = task_evaluation.check_expected_results(
            results, cfg.EXPECTED_RESULTS,
            atol=cfg.EXPECTED_RESULTS_ATOL, rtol=cfg.EXPECTED_RESULTS_RTOL,
        )
        if failures and cfg.EXPECTED_RESULTS_EMAIL:
            # reference lib/utils/logging.py:86-92 (email on regression)
            from cim_tpu_torch.engine.stats import send_failure_email

            send_failure_email(
                "CIM expected-results regression", "\n".join(failures),
                cfg.EXPECTED_RESULTS_EMAIL,
            )
        if failures:
            raise AssertionError("expected results not met: " + "; ".join(failures))
    return results, all_boxes, all_scores


def child_env(i: int, env: dict, n_cards: int) -> dict:
    """The environment of --multi_proc child i: with more than one visible
    card, CUDA_VISIBLE_DEVICES names card i % n_cards alone (of the
    parent's own CUDA_VISIBLE_DEVICES where it has one; the reference's
    lib/utils/subprocess.py); with one card or none, ``env`` as it is."""
    if n_cards <= 1:
        return env
    visible = env.get("CUDA_VISIBLE_DEVICES")
    cards = visible.split(",") if visible else [str(c) for c in range(n_cards)]
    return {**env, "CUDA_VISIBLE_DEVICES": cards[i % n_cards].strip()}


def multi_process_inference(cfg, child_argv, n_procs, output_dir, check_corloc=False,
                            check_expected_results=False):
    """The reference's fan-out over processes (multi_gpu_test_net_on_dataset,
    lib/core/test_engine.py:204-244, and utils/subprocess.py:41-145): split
    the dataset into ``n_procs`` contiguous index ranges, run one child
    ``python -m cim_tpu_torch.tools.test_net *child_argv --range s e`` per
    range, wait for every child, require each to exit 0, merge their range
    pickles into one and post-process and evaluate in this process. The
    children inherit the environment (child_env: one card each when there
    are several); this package's root joins their PYTHONPATH so that they
    import it. Returns (results, all_boxes, all_scores)."""
    import subprocess
    import sys

    from cim_tpu_torch.parallel import eval_index_range, merge_sharded_results

    dataset_name = cfg.TEST.DATASETS[0]
    proposal_file = cfg.TEST.PROPOSAL_FILES[0] if cfg.TEST.PROPOSAL_FILES else None
    roidb, dataset, _, _, _ = get_roidb_and_dataset(cfg, dataset_name, proposal_file)
    n = len(roidb)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    n_cards = torch.cuda.device_count()
    procs = []
    for i in range(n_procs):
        s, e = eval_index_range(n, i, n_procs)
        if s == e:
            continue
        cmd = [sys.executable, "-m", "cim_tpu_torch.tools.test_net", *child_argv,
               "--range", str(s), str(e)]
        logger.info("spawning shard [%d, %d): %s", s, e, " ".join(cmd))
        procs.append((s, e, subprocess.Popen(cmd, env=child_env(i, env, n_cards))))
    # wait for every child before judging any: failing at the first would
    # leave the others running, each holding its device
    failed = [(s, e, rc) for s, e, p in procs if (rc := p.wait()) != 0]
    if failed:
        raise RuntimeError(f"child shards failed as (start, end, exit code): {failed}")

    base = _det_basename(check_corloc)
    all_scores = merge_sharded_results(
        [load_object(os.path.join(output_dir, f"{base}_range_{s}_{e}.pkl")) for s, e, _ in procs])
    if len(all_scores) != n:
        raise RuntimeError(f"the shards hold {len(all_scores)} images of {n}")
    save_object(all_scores, os.path.join(output_dir, f"{base}.pkl"))
    return _post_process_and_evaluate(
        cfg, all_scores, roidb, dataset, output_dir, check_corloc, check_expected_results,
    )
