"""N-step training stability run at production shape on one CUDA card
(port of tools/stability_run.py).

    python -m cim_tpu_torch.tools.stability_run --steps 60 --batch_pool 4
    python -m cim_tpu_torch.tools.stability_run --device cpu --steps 3 \\
        --image_hw 64 64 --n_props 24 --precision f32 \\
        --set MODEL.CONV_BODY tiny.conv_body    # on the CPU, the tiny body

The README's stability experiment: the full resnet50_voc Trainer step
(GRAD_ACCUM 4, RoIAlign cap 4) on synthetic --image_hw batches with
--n_props proposals padded to their bucket (2000 -> 2048), a fresh batch
every step or a pool of --batch_pool batches staged on the device and
cycled. Each step's anti-noise draws come from the Trainer's seeds derived
from (seed, step, microbatch). Passes if every total_loss is finite and,
at --steps >= 40, total_loss falls from the first step to the last.
Reports s/step and images/s of the steady state (steps after the first,
each timed on the host clock around a synced step) and the peak device
memory.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from cim_tpu_torch.config import cfg_from_list, clone_cfg, load_cfg
from cim_tpu_torch.data.loader import proposal_bucket
from cim_tpu_torch.data.synthetic import make_train_batch
from cim_tpu_torch.engine.train import Trainer
from cim_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", default=os.path.join(REPO, "configs", "resnet50_voc.yaml"))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--n_props", type=int, default=2000)
    ap.add_argument("--image_hw", type=int, nargs=2, default=(384, 512))
    ap.add_argument("--disp", type=int, default=10)
    ap.add_argument("--precision", default=None,
                    help="override cfg.TPU.PRECISION (f32 | bf16_compute)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json_out", default=None, help="dump the loss trajectory as JSON")
    ap.add_argument("--batch_pool", type=int, default=0,
                    help="stage N distinct batches on the device and cycle them; "
                    "0 = a fresh host batch every step")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--set", dest="set_cfgs", nargs="+", default=None,
                    help="config key-value pairs, applied after the yaml")
    return ap.parse_args(argv)


def configure(args):
    cfg = clone_cfg(load_cfg(args.cfg))
    if args.set_cfgs:
        cfg_from_list(cfg, args.set_cfgs)
    cfg.TPU.DATA_PARALLEL = 1
    cfg.TPU.PALLAS_ROI_ALIGN = True  # the kernel's grid cap (4), as cim_tpu's tool
    if args.precision is not None:
        cfg.TPU.PRECISION = args.precision
    return cfg


def to_device(batch, device):
    """A step's batch as tensors on ``device`` (image_hw stays on the host),
    so that Trainer.microbatch moves nothing."""
    return {k: v if k == "image_hw" else torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def run_steps(trainer, next_batch, steps, disp=10, log=print):
    """``steps`` Trainer steps on next_batch(i); returns (history of each
    step's loss metrics, seconds of each step). Raises on a non-finite
    total_loss."""
    history, secs = [], []
    sync = trainer.device.type == "cuda"
    for i in range(steps):
        batch = next_batch(i)
        if sync:
            torch.cuda.synchronize(trainer.device)
        t0 = time.perf_counter()
        m = trainer.step(batch)  # ends in the metrics' copy to the host
        secs.append(time.perf_counter() - t0)
        losses = {k: float(v) for k, v in m.items() if k.endswith("loss")}
        history.append(losses)
        if not np.isfinite(losses["total_loss"]):
            raise FloatingPointError(f"step {i}: non-finite total_loss {losses}")
        if i % disp == 0 or i == steps - 1:
            log(f"step {i:4d} " + " ".join(f"{k}={v:.4f}" for k, v in sorted(losses.items())))
    return history, secs


def main(argv=None):
    """Run; returns a summary: device, steps, the first and last
    total_loss, the history, steady s/step and images/s, and the peak
    device memory (None on the CPU)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = configure(args)
    accum = cfg.TPU.GRAD_ACCUM
    rng = np.random.RandomState(args.seed)
    kw = dict(image_hw=tuple(args.image_hw), n_props=proposal_bucket(cfg, args.n_props),
              n_valid=args.n_props, num_classes=cfg.MODEL.NUM_CLASSES)

    def host_batch():
        return {k: v[0] for k, v in make_train_batch(rng, 1, accum, **kw).items()}

    trainer = Trainer(cfg, device=device, seed=args.seed,
                      init_generator=torch.Generator(device=device).manual_seed(args.seed))
    pool = [to_device(host_batch(), device) for _ in range(args.batch_pool)]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    history, secs = run_steps(
        trainer, (lambda i: pool[i % len(pool)]) if pool else (lambda i: host_batch()),
        args.steps, args.disp, log=lambda s: print(s, flush=True))
    first, last = history[0]["total_loss"], history[-1]["total_loss"]
    steady = float(np.mean(secs[1:])) if len(secs) > 1 else None
    summary = {
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "precision": cfg.TPU.PRECISION, "steps": args.steps, "grad_accum": accum,
        "image_hw": list(args.image_hw), "n_props": args.n_props,
        "proposal_pad": kw["n_props"], "batch_pool": args.batch_pool,
        "first_total_loss": first, "last_total_loss": last,
        "s_per_step_steady": steady,
        "images_per_sec_steady": accum / steady if steady else None,
        "first_step_s": secs[0],
        "peak_device_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                           if device.type == "cuda" else None),
        "history": history,
    }
    print(json.dumps({k: v for k, v in summary.items() if k != "history"}), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(summary, f)
    # fresh random batches and the linear warm-up: the decrease is only
    # resolvable above the step-to-step noise on longer runs
    if args.steps >= 40 and not last < first:
        raise AssertionError(f"total_loss did not decrease: {first} -> {last}")
    return summary


if __name__ == "__main__":
    main()
