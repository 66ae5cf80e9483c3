"""Segmented long-horizon training runs (port of tools/long_horizon_run.py).

    python -m cim_tpu_torch.tools.long_horizon_run --total_steps 1000 \\
        --segment_steps 250 --decay_at 600 --warmup 100 --out run.json
    python -m cim_tpu_torch.tools.long_horizon_run --device cpu --total_steps 24 \\
        --segment_steps 12 --decay_at 16 --warmup 4 --disp 4 \\
        --synth_image 64 64 --synth_props 32 --synth_valid 24 \\
        --set MODEL.CONV_BODY tiny.conv_body --out /tmp/r.json   # on the CPU

Runs ``python -m cim_tpu_torch.tools.train --synthetic`` for --total_steps
in fresh-process segments of --segment_steps, each segment resuming the
previous one's checkpoint (--load_ckpt ... --resume), so that a run at
horizon goes through the crash-save/resume path and crosses the LR decay
boundary (--decay_at, in optimizer steps, -> SOLVER.STEPS) mid-run, with
the warm-up at its start (reference tools/train.py:407-416; the 90k budget
of configs/resnet50_voc.yaml:22-26, scaled down here). Each segment draws
new synthetic data (--seed 3 + segment) and runs at the world size
--devices (TPU.DATA_PARALLEL pinned to it, else the decay lands at another
step on a machine with more cards).

Collects every TrainingStats line ({"iter": ...}) across the segments and
writes one result JSON, with cim_tpu's keys: the loss and mining-health
(fg_frac / mined_gt / has_gt) trajectory, the LR drop measured at the
decay boundary, and each segment's first and last loss and wall time.
Beside cim_tpu's fields each segment reports its own peak device memory,
peak host RSS and RoIAlign launches, read from the train CLI's closing
{"run_end": ...} line. A partial artifact is written atomically after
every segment; --resume_from continues an interrupted run from it. A
segment that exits non-zero, or stops short of its last step, fails the
run: the partial artifact is written with the error and main raises.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

from cim_tpu_torch.config import cfg_from_file, get_default_cfg

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STATS_RE = re.compile(r'(\{"iter": .*\})')
RUN_END_RE = re.compile(r'(\{"run_end": .*\})')


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cfg", default=os.path.join(REPO, "configs", "resnet50_voc.yaml"))
    p.add_argument("--total_steps", type=int, default=5000)
    p.add_argument("--segment_steps", type=int, default=500)
    p.add_argument("--decay_at", type=int, default=3000,
                   help="SOLVER.STEPS decay boundary in optimizer steps (scaled-down 60k)")
    p.add_argument("--warmup", type=int, default=500, help="SOLVER.WARM_UP_ITERS")
    p.add_argument("--disp", type=int, default=20)
    p.add_argument("--iter_size", type=int, default=4)
    p.add_argument("--devices", type=int, default=1,
                   help="the segments' world size (TPU.DATA_PARALLEL)")
    p.add_argument("--synth_image", nargs=2, type=int, default=(256, 256))
    p.add_argument("--synth_props", type=int, default=512)
    p.add_argument("--synth_valid", type=int, default=300)
    p.add_argument("--workdir", default=None)
    p.add_argument("--out", default="long_horizon_run.json")
    p.add_argument("--resume_from", default=None,
                   help="partial artifact of an interrupted run; continues from the next "
                   "segment (requires --workdir pointing at the same checkpoint dir)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--set", dest="set_cfgs", nargs="+", default=[])
    return p.parse_args(argv)


def _prescale_decay(args):
    """The train CLI rescales SOLVER.STEPS by NUM_GPUS / (iter_size *
    devices) (the reference's batch/LR/step rescale, tools/train.py:184-221,
    the port's tools/train.rescale_solver); --decay_at is in optimizer
    steps, so invert the scale here."""
    cfg = get_default_cfg()
    cfg_from_file(cfg, args.cfg)
    return int(round(args.decay_at * args.iter_size * args.devices / cfg.NUM_GPUS))


def run_segment(args, seg_idx, workdir, max_iter):
    """One fresh-process segment: (rc, its stats lines, its run_end dict or
    None, wall seconds, its log)."""
    cmd = [
        sys.executable, "-m", "cim_tpu_torch.tools.train",
        "--synthetic", "--cfg", args.cfg, "--device", args.device,
        "--max_iter", str(max_iter),
        "--disp_interval", str(args.disp),
        "--iter_size", str(args.iter_size),
        "--output_dir", workdir,
        "--synth_image", str(args.synth_image[0]), str(args.synth_image[1]),
        "--synth_props", str(args.synth_props),
        "--synth_valid", str(args.synth_valid),
        # a continuous-ish data stream: new segment, new synthetic draw
        "--seed", str(3 + seg_idx),
        # the reference's convention: STEPS[0] is the start (0), the decays
        # are the remaining entries (lib/utils/net.py steps_with_decay); the
        # value is prescaled so that the CLI's rescale lands it at --decay_at
        "--set", "SOLVER.STEPS", f"[0,{_prescale_decay(args)}]",
        "SOLVER.WARM_UP_ITERS", str(args.warmup),
        # a snapshot only at the segment's end (the CLI's final save)
        "TRAIN.SNAPSHOT_ITERS", str(10**9),
        "TPU.DATA_PARALLEL", str(args.devices),
    ] + list(args.set_cfgs)
    if seg_idx > 0:
        cmd += ["--load_ckpt", os.path.join(workdir, "ckpt"), "--resume"]
    t0 = time.time()
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO)
    dt = time.time() - t0
    log = r.stdout + r.stderr
    stats = [json.loads(m.group(1)) for m in STATS_RE.finditer(log)]
    ends = [json.loads(m.group(1))["run_end"] for m in RUN_END_RE.finditer(log)]
    if r.returncode != 0:
        sys.stderr.write(log[-4000:] + "\n")
    return r.returncode, stats, (ends[-1] if ends else None), dt, log


def main(argv=None):
    """Run the segments; returns the result JSON's dict (also written to
    --out and printed without the trajectory)."""
    args = parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="long_run_")
    os.makedirs(workdir, exist_ok=True)

    n_segments = (args.total_steps + args.segment_steps - 1) // args.segment_steps
    trajectory = []
    seg_summaries = []
    boundary_losses = []
    start_seg = 0
    if args.resume_from:
        with open(args.resume_from) as f:
            prev = json.load(f)
        if prev["segment_steps"] != args.segment_steps or prev["total_steps"] != args.total_steps:
            raise ValueError("--resume_from holds a run of other --segment_steps / --total_steps")
        if not args.workdir:
            raise ValueError("--resume_from requires --workdir (the checkpoint dir)")
        trajectory = prev["trajectory_every_disp"]
        boundary_losses = prev["segment_boundaries"]
        seg_summaries = prev["segments_wall"]
        start_seg = len(seg_summaries)
        print(json.dumps({"resumed_at_segment": start_seg,
                          "steps_done": prev["steps_completed"]}), flush=True)
    for seg in range(start_seg, n_segments):
        max_iter = min((seg + 1) * args.segment_steps, args.total_steps)
        rc, stats, run_end, dt, log = run_segment(args, seg, workdir, max_iter)
        # the CLI saves a crash and returns: a segment that stopped short of
        # its last step fails the run as a non-zero exit does
        short = run_end is None or run_end["step"] != max_iter
        if rc != 0 or short:
            # keep the trajectory captured so far; merge the error fields
            # into the summary instead of discarding the partial artifact
            failed = _summarize(args, n_segments, trajectory, boundary_losses,
                                seg_summaries, partial=True)
            failed.update({"ok": False, "failed_segment": seg, "rc": rc,
                           "run_end": run_end, "error_tail": log[-1500:]})
            _write(args.out, failed)
            raise RuntimeError(f"segment {seg} failed (rc {rc}, run_end {run_end}):\n"
                               f"{log[-1500:]}")
        # stats lines of THIS segment only (iter > the previous max)
        prev_max = trajectory[-1]["iter"] if trajectory else -1
        fresh = [s for s in stats if s["iter"] > prev_max]
        trajectory.extend(fresh)
        if fresh:
            boundary_losses.append(
                {"segment": seg, "first_iter": fresh[0]["iter"],
                 "first_loss": fresh[0]["loss"], "last_iter": fresh[-1]["iter"],
                 "last_loss": fresh[-1]["loss"]}
            )
        mem = run_end["max_memory_allocated"]
        seg_summaries.append({
            "segment": seg, "max_iter": max_iter, "wall_s": round(dt, 1),
            "stats_lines": len(fresh), "device": run_end["device"],
            "peak_device_gb": None if mem is None else round(mem / 1e9, 3),
            "peak_rss_gb": round(run_end["ru_maxrss_kb"] * 1024 / 1e9, 3),
            "roi_align_fwd_launches": run_end["roi_align_fwd_launches"],
            "roi_align_bwd_launches": run_end["roi_align_bwd_launches"],
            "nms_launches": run_end["nms_launches"],
        })
        print(json.dumps(seg_summaries[-1]), flush=True)
        # a partial artifact after every segment: a run bounded by the clock
        # still leaves the trajectory captured so far (the full artifact is
        # written once, after the loop)
        if seg + 1 < n_segments:
            _write(args.out, _summarize(args, n_segments, trajectory, boundary_losses,
                                        seg_summaries, partial=True))

    result = _summarize(args, n_segments, trajectory, boundary_losses, seg_summaries,
                        partial=False)
    _write(args.out, result)
    print(json.dumps({k: v for k, v in result.items() if k != "trajectory_every_disp"}),
          flush=True)
    return result


def _summarize(args, n_segments, trajectory, boundary_losses, seg_summaries, partial):
    losses = [s["loss"] for s in trajectory]
    lrs = {s["iter"]: s["lr"] for s in trajectory}
    pre = [lr for it, lr in lrs.items() if args.warmup <= it < args.decay_at]
    post = [lr for it, lr in lrs.items() if it >= args.decay_at + args.disp]

    # mining health at the end vs the start (median over the last / first 5 lines)
    def med(key, rows):
        vals = [r[k] for r in rows for k in r if k.startswith(key)]
        return round(float(np.median(vals)), 4) if vals else None

    head, tail = trajectory[:5], trajectory[-5:]
    return {
        "ok": bool(losses) and all(np.isfinite(losses)),
        "partial": partial,
        "steps_completed": trajectory[-1]["iter"] + 1 if trajectory else 0,
        "total_steps": args.total_steps,
        "segments": n_segments,
        "segment_steps": args.segment_steps,
        "decay_at": args.decay_at,
        "warmup": args.warmup,
        "first_loss": losses[0] if losses else None,
        "final_loss": losses[-1] if losses else None,
        "loss_decreased": bool(losses and losses[-1] < losses[0]),
        "lr_pre_decay": pre[-1] if pre else None,
        "lr_post_decay": post[0] if post else None,
        "lr_decay_ratio": round(post[0] / pre[-1], 4) if pre and post else None,
        "mining_health": {
            "fg_frac_start": med("fg_frac", head),
            "fg_frac_end": med("fg_frac", tail),
            "mined_gt_start": med("mined_gt", head),
            "mined_gt_end": med("mined_gt", tail),
            "has_gt_end": med("has_gt", tail),
        },
        "segment_boundaries": boundary_losses,
        "segments_wall": seg_summaries,
        "trajectory_every_disp": trajectory,
    }


def _write(path, obj):
    # atomic replace: a kill mid-write leaves the previous good partial
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=1)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
