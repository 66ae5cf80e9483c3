"""CIM training CLI on CUDA cards (port of tools/train.py).

    python -m cim_tpu_torch.tools.train --dataset voc2012trainaug \\
        --cfg configs/resnet50_voc.yaml
    python -m cim_tpu_torch.tools.train --synthetic --cfg configs/resnet50_voc.yaml \\
        --max_iter 20                   # smoke run without data on disk
    python -m cim_tpu_torch.tools.train --device cpu --cfg configs/resnet50_voc.yaml \\
        --set MODEL.CONV_BODY tiny.conv_body ...   # on the CPU, the tiny body
    torchrun --nnodes 2 --nproc_per_node 8 ... -m cim_tpu_torch.tools.train \\
        --multihost --cfg ...           # across nodes, one process a card

The reference's training contract, as cim_tpu's CLI keeps it: dataset
presets, a cfg yaml with --set overrides, LR and step rescaling by the
effective batch (reference tools/train.py:184-221), gradient accumulation
(--iter_size), snapshots, and a checkpoint saved on a crash. The loop is
cim_tpu's one-deep pipeline: it dispatches step i (Trainer.step_async)
and only then reads and logs step i - 1's metrics, so the host builds and
dispatches the next step while the card runs this one. Batches of the
real data path come from data.loader.TrainLoader in pinned host memory.

Data parallelism: TPU.DATA_PARALLEL ranks, one a card (0, the shipped
configs' value, means every visible card; 1 on the CPU), started by
parallel.launch (spawned here, or by torchrun; --multihost requires
torchrun), over NCCL between cards and gloo on the CPU. The world size
rescales the LR, the steps and the snapshot period as cim_tpu's device
count does. Each rank reads its own strided shard of the roidb
(parallel.host_shard_roidb) with its own loader; rank 0 alone writes the
config pickle, the snapshots and tensorboard, and logs. main() returns
rank 0's summary. Unlike cim_tpu's CLI, a resumed run (--load_ckpt
--resume) continues each rank's batch sequence where the checkpoint left
it, so that it reproduces the uninterrupted run.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import pickle
import resource
import socket
import time
import traceback

import numpy as np
import torch

from cim_tpu_torch import parallel
from cim_tpu_torch.config import assert_and_infer_cfg, cfg_from_file, cfg_from_list, get_default_cfg
from cim_tpu_torch.data import catalog
from cim_tpu_torch.engine.checkpoint import checkpoint_location, load_ckpt, save_ckpt
from cim_tpu_torch.engine.stats import TrainingStats, setup_logging
from cim_tpu_torch.engine.train import Trainer, metrics_to_floats
from cim_tpu_torch.ops.nms import greedy_nms_from_iou
from cim_tpu_torch.ops.roi_align import roi_align, roi_align_backward
from cim_tpu_torch.utils.device import resolve_device
from cim_tpu_torch.utils.trace import Profile

logger = logging.getLogger("cim_tpu_torch.tools.train")

PROFILE_STEPS = (5, 10)  # --profile_dir traces steps [5, 10)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train CIM (PyTorch, CUDA cards)")
    parser.add_argument("--dataset", help="voc2012trainaug | coco2017train")
    parser.add_argument("--cfg", dest="cfg_file", required=True)
    parser.add_argument("--set", dest="set_cfgs", nargs="+", default=None,
                        help="config key-value pairs")
    parser.add_argument("--bs", dest="batch_size", type=int, default=None,
                        help="total images per step across devices")
    parser.add_argument("--iter_size", type=int, default=4)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--lr_decay_gamma", type=float, default=None,
                        help="override cfg.SOLVER.GAMMA (reference tools/train.py:95-98)")
    parser.add_argument("-o", "--optimizer", default=None,
                        help="override SOLVER.TYPE (SGD | Adam)")
    parser.add_argument("--max_iter", type=int, default=None)
    parser.add_argument("--disp_interval", type=int, default=20)
    parser.add_argument("--output_dir", default=None)
    parser.add_argument("--load_ckpt", default=None,
                        help="a checkpoint directory (its latest step) or one model_step<n>.pth")
    parser.add_argument("--load_detectron", default=None,
                        help="Detectron-pkl weight file (reference tools/train.py:338-340)")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--no_save", action="store_true")
    parser.add_argument("--use_tfboard", action="store_true")
    parser.add_argument("--start_step", type=int, default=0)
    parser.add_argument("--seed", type=int, default=3)
    parser.add_argument("--synthetic", action="store_true",
                        help="train on synthetic fixtures (no data on disk)")
    parser.add_argument("--synth_image", nargs=2, type=int, default=(256, 256),
                        help="synthetic image bucket H W")
    parser.add_argument("--synth_props", type=int, default=512,
                        help="synthetic proposal pad (bucket size)")
    parser.add_argument("--synth_valid", type=int, default=300,
                        help="synthetic valid-proposal count")
    parser.add_argument("--multihost", action="store_true",
                        help="launched by torchrun across nodes (TPU.DATA_PARALLEL: 0 for "
                        "every rank it started)")
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler trace of steps 5-10 there")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    return parser.parse_args(argv)


def rescale_solver(cfg, batch_size: int, iter_size: int):
    """The reference's rescaling by the effective batch (reference
    tools/train.py:184-221, cim_tpu tools/train.py:119-130): the LR by the
    batch per step, the decay steps and MAX_ITER by the images a step
    against the config's original batch."""
    original_batch_size = cfg.NUM_GPUS * cfg.TRAIN.IMS_PER_BATCH
    old_lr = cfg.SOLVER.BASE_LR
    cfg.SOLVER.BASE_LR *= batch_size / original_batch_size
    step_scale = original_batch_size / (iter_size * batch_size)
    cfg.SOLVER.STEPS = [int(s * step_scale + 0.5) for s in cfg.SOLVER.STEPS]
    cfg.SOLVER.MAX_ITER = int(cfg.SOLVER.MAX_ITER * step_scale + 0.5)
    logger.info("batch %d x iter_size %d -> LR %g -> %g, MAX_ITER %d, STEPS %s",
                batch_size, iter_size, old_lr, cfg.SOLVER.BASE_LR,
                cfg.SOLVER.MAX_ITER, cfg.SOLVER.STEPS)


def snapshot_period(cfg, n_devices: int, iter_size: int) -> int:
    """Steps between snapshots (cim_tpu tools/train.py:256-258)."""
    return max(1, int(cfg.TRAIN.SNAPSHOT_ITERS / (n_devices * iter_size)))


class _TensorBoard:
    """torch.utils.tensorboard behind the scalar() / close() calls that
    TrainingStats makes (flax's writer's, in cim_tpu)."""

    def __init__(self, log_dir):
        from torch.utils.tensorboard import SummaryWriter

        self._writer = SummaryWriter(log_dir)

    def scalar(self, tag, value, step):
        self._writer.add_scalar(tag, value, step)

    def close(self):
        self._writer.close()


def resolve_world(data_parallel, device: torch.device, multihost: bool = False) -> int:
    """The run's ranks from TPU.DATA_PARALLEL (cim_tpu: ``or
    len(jax.devices())``): 0 means every visible card on cuda (every rank
    torchrun started, with --multihost) and 1 on the CPU; n means n, and on
    cuda n above the visible cards raises (the CLI puts one rank on each
    card). Under torchrun its WORLD_SIZE must be that number."""
    n = int(data_parallel or 0)
    env_world = os.environ.get("WORLD_SIZE")
    if multihost:
        if env_world is None:
            raise RuntimeError("--multihost means launched by torchrun across nodes; "
                               "WORLD_SIZE is not set")
        n = n or int(env_world)
    elif device.type == "cuda":
        visible = torch.cuda.device_count()
        if n > visible:
            raise RuntimeError(f"TPU.DATA_PARALLEL={n} ranks, one a card, but {visible} "
                               "card(s) are visible")
        n = n or visible
    else:
        n = n or 1
    if env_world is not None and int(env_world) != n:
        raise RuntimeError(f"torchrun started WORLD_SIZE={env_world} ranks, but "
                           f"TPU.DATA_PARALLEL resolves to {n}")
    return n


def _configure(args):
    cfg = get_default_cfg()
    cfg_from_file(cfg, args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(cfg, args.set_cfgs)
    if args.dataset == "coco2017train":
        cfg.TRAIN.DATASETS = ("coco_2017_train",)
        cfg.MODEL.NUM_CLASSES = 80
    elif args.dataset == "voc2012trainaug":
        cfg.TRAIN.DATASETS = ("voc_2012_trainaug",)
        cfg.MODEL.NUM_CLASSES = 20
    elif args.dataset is not None:
        raise ValueError(f"Unexpected args.dataset: {args.dataset}")
    if args.debug:
        cfg.DEBUG = True
    n_devices = resolve_world(cfg.TPU.DATA_PARALLEL, torch.device(args.device), args.multihost)
    cfg.TPU.DATA_PARALLEL = n_devices
    # --bs rescales the LR and steps as cim_tpu's does; a microbatch is one image
    batch_size = args.batch_size or n_devices * cfg.TRAIN.IMS_PER_BATCH
    cfg.TPU.GRAD_ACCUM = args.iter_size
    rescale_solver(cfg, batch_size, args.iter_size)
    if args.optimizer is not None:
        cfg.SOLVER.TYPE = args.optimizer
    if args.lr is not None:
        cfg.SOLVER.BASE_LR = args.lr
    if args.lr_decay_gamma is not None:
        cfg.SOLVER.GAMMA = args.lr_decay_gamma
    if args.max_iter is not None:
        cfg.SOLVER.MAX_ITER = args.max_iter
    assert_and_infer_cfg(cfg, make_immutable=False)
    if args.synthetic:
        cfg.TPU.PROPOSAL_PAD = min(cfg.TPU.PROPOSAL_PAD, args.synth_props)
    return cfg, n_devices


def _data(cfg, args, device, start: int, rank: int = 0, world: int = 1):
    """(iterator of this rank's step batches, the loader or None)."""
    if args.synthetic:
        from cim_tpu_torch.data.synthetic import make_train_batch

        rng = np.random.RandomState(args.seed)
        kw = dict(
            image_hw=tuple(args.synth_image),
            n_props=cfg.TPU.PROPOSAL_PAD,
            n_valid=min(cfg.TPU.PROPOSAL_PAD, args.synth_valid),
            num_classes=cfg.MODEL.NUM_CLASSES,
        )

        def batches():
            # cim_tpu's (devices, accum) batch from one generator; the rank's row
            while True:
                batch = make_train_batch(rng, world, args.iter_size, **kw)
                yield {k: v[rank] for k, v in batch.items()}

        return batches(), None
    from cim_tpu_torch.data.loader import TrainLoader
    from cim_tpu_torch.data.roidb import combined_roidb_for_training

    roidb, _, _ = combined_roidb_for_training(cfg)
    roidb = parallel.host_shard_roidb(roidb, rank, world)
    loader = TrainLoader(cfg, roidb, args.iter_size, seed=args.seed,
                         prefetch=cfg.DATA_LOADER.PREFETCH,
                         pin_memory=device.type == "cuda", start=start)
    return iter(loader), loader


def _load_weights(trainer, args):
    if args.load_ckpt:
        ckpt_dir, step = checkpoint_location(args.load_ckpt)
        load_ckpt(ckpt_dir, trainer, step)
        if not args.resume:
            trainer.step_count = args.start_step
        logger.info("Loaded checkpoint; starting at step %d", trainer.step_count)
    elif args.load_detectron:
        from cim_tpu_torch.utils.detectron_weights import load_detectron_pkl

        trainer.load_weights(load_detectron_pkl(args.load_detectron))
        logger.info("Loaded Detectron pkl weights from %s", args.load_detectron)


def main(argv=None, profile_steps=PROFILE_STEPS):
    """Train; profile_steps: the [first, last) steps --profile_dir traces
    (on rank 0). Returns a summary of the run (rank 0's, or under torchrun
    this process's rank's): its output_dir, the final step, each step's
    metrics as logged (the mean over ranks), its world size and whether
    the trainer ran under DDP, the steps that wrote a snapshot, the files
    this rank wrote, host times (the wait for the
    loader and the loop's time a step, and the loader's build time a
    batch), the profile's, and "run_end": the step reached, the device's
    name, the process's peak device memory and host RSS, and the run's
    RoIAlign launches, also logged as the run's last JSON line. With ranks
    spawned here, "ranks" holds every rank's summary."""
    setup_logging()
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg, n_devices = _configure(args)
    # timestamped run dir (reference lib/utils/misc.py get_run_name), named
    # once for every rank
    run_name = "%s_%s_step" % (time.strftime("%b%d-%H-%M-%S"), socket.gethostname())
    output_dir = args.output_dir or os.path.join(
        cfg.OUTPUT_DIR, os.path.splitext(os.path.basename(args.cfg_file))[0], run_name)
    # spawned ranks import the catalog afresh: hand them this process's
    results = parallel.launch(_train, n_devices, device,
                              args=(args, cfg, output_dir, profile_steps, dict(catalog.DATASETS)))
    summary = dict(results[min(results)])
    if len(results) > 1:
        summary["ranks"] = [results[r] for r in sorted(results)]
    return summary


def _train(device, args, cfg, output_dir, profile_steps, datasets):
    """One rank's run (the whole run at world size 1)."""
    setup_logging()  # a spawned rank starts from a fresh interpreter
    launches0 = (roi_align.kernel_launches, roi_align_backward.kernel_launches,
                 greedy_nms_from_iou.kernel_launches)
    catalog.DATASETS.update(datasets)
    rank, world = parallel.rank(), parallel.world_size()
    if rank != 0:
        logging.getLogger().setLevel(logging.WARNING)  # rank 0 logs the run
    trainer = Trainer(cfg, device=device, seed=args.seed,
                      init_generator=torch.Generator(device=device).manual_seed(args.seed))
    _load_weights(trainer, args)
    step = trainer.step_count
    loader_iter, loader = _data(cfg, args, device, start=step if args.resume else 0,
                                rank=rank, world=world)

    ckpt_dir = os.path.join(output_dir, "ckpt")
    do_save = not args.no_save  # every rank calls save_ckpt; rank 0 writes
    summary = {"output_dir": output_dir, "world": world, "ddp": trainer.ddp is not None,
               "metrics": [], "loader_wait_s": [], "loop_s": [], "snapshots": [],
               "written": [], "profile": None}
    if do_save and rank == 0:
        os.makedirs(output_dir, exist_ok=True)
        path = os.path.join(output_dir, "config_and_args.pkl")
        with open(path, "wb") as f:
            pickle.dump({"cfg": dict(cfg), "args": vars(args)}, f)
        summary["written"].append(path)

    tb_writer = None
    if args.use_tfboard and do_save and rank == 0:
        try:
            tb_writer = _TensorBoard(output_dir)
        except Exception as e:  # the tensorboard package may be missing
            logger.warning("tensorboard writer unavailable: %s", e)

    training_stats = TrainingStats(args.disp_interval, tb_writer)
    period = snapshot_period(cfg, world, args.iter_size)

    def save(sync=True):
        path = save_ckpt(ckpt_dir, trainer, sync=sync)
        if path is not None:
            summary["written"].append(path)

    saved_at = None
    profiler = None
    pending = None  # (step index, device metrics): the one-deep pipeline

    def flush_pending(force=False):
        """Read and log the previous step's metrics (waits for that step).
        Shared by the loop, the final flush, the profiler's stop and the
        crash path (so that the last completed step reaches the logs)."""
        nonlocal pending
        if pending is None:
            return False
        p_step, p_dev = pending
        pending = None
        p_metrics = metrics_to_floats(p_dev)
        training_stats.update_iter_stats(p_metrics)
        training_stats.log_iter_stats(p_step, p_metrics["lr"], cfg.SOLVER.MAX_ITER, force=force)
        summary["metrics"].append((p_step, p_metrics))
        return True

    def stop_profile():
        nonlocal profiler
        flush_pending()  # keep the last step in the trace
        summary["profile"] = profiler.stop(steps=step - profile_steps[0])
        profiler = None

    try:
        logger.info("Training starts!")
        t_loop = time.perf_counter()
        while step < cfg.SOLVER.MAX_ITER:
            if args.profile_dir and rank == 0 and step == profile_steps[0] and profiler is None:
                profiler = Profile(args.profile_dir, device)
            if profiler is not None and step >= profile_steps[1]:
                stop_profile()
            t0 = time.perf_counter()
            batch = next(loader_iter)
            summary["loader_wait_s"].append(time.perf_counter() - t0)
            training_stats.iter_tic()
            metrics_dev = trainer.step_async(batch)
            step += 1
            # read the previous step's metrics only now, so that the next
            # batch's host work overlaps this step on the card; the first
            # step has none to read and its dispatch time is not counted
            if flush_pending():
                training_stats.iter_toc()
            pending = (step - 1, metrics_dev)
            if do_save and step % period == 0:
                save()
                saved_at = step
                summary["snapshots"].append(step)
            now = time.perf_counter()
            summary["loop_s"].append(now - t_loop)
            t_loop = now
        flush_pending(force=True)  # the last step's metrics
        if profiler is not None:
            stop_profile()
        if do_save and saved_at != step:
            save()
        logger.info("Training done at step %d", step)
    except (RuntimeError, KeyboardInterrupt):
        # crash-save (reference tools/train.py:450-456), after the pending
        # metrics: the last completed step's state is what is saved, by
        # rank 0 and without a barrier (the other ranks may not reach one);
        # parallel.launch then tears the group down
        try:
            flush_pending(force=True)
        except Exception:  # the read itself may be what failed
            logger.warning("pending metrics unrecoverable on crash")
        logger.info("Save ckpt on exception ...")
        if do_save:
            save(sync=False)
        print(traceback.format_exc())
    finally:
        if tb_writer is not None:
            tb_writer.close()
        if loader is not None:
            loader.close()
            summary["loader_build_s"] = list(loader.build_seconds)
    summary["step"] = trainer.step_count
    # the closing line: what a runner of fresh-process segments
    # (tools/long_horizon_run.py) reads of each; the peaks are the process's
    summary["run_end"] = {
        "step": trainer.step_count,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None),
        "ru_maxrss_kb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss,
        "roi_align_fwd_launches": roi_align.kernel_launches - launches0[0],
        "roi_align_bwd_launches": roi_align_backward.kernel_launches - launches0[1],
        "nms_launches": greedy_nms_from_iou.kernel_launches - launches0[2],
    }
    logger.info(json.dumps({"run_end": summary["run_end"]}))
    return summary


if __name__ == "__main__":
    main()
