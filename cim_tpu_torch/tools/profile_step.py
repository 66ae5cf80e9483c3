"""Train-step time breakdown at production shape on one CUDA card (port of
tools/profile_step.py).

    python -m cim_tpu_torch.tools.profile_step
    python -m cim_tpu_torch.tools.profile_step --device cpu --image_hw 64 64 \\
        --n_valid 24 --iters 2 --set MODEL.CONV_BODY tiny.conv_body \\
        TPU.PRECISION f32                    # on the CPU, the tiny body

Prints the steady-state ms a call of: the model's forward alone, the 3
CIM mining branches alone (on that forward's outputs), forward + mining +
losses, forward + backward, and the full accumulated Trainer step a
image. Each runs once to warm up, then --iters times between two
synchronizations of the card. The parts are the Trainer's own
(Trainer.model, Trainer.loss_fn, engine.train.mine_pseudo_labels through
Trainer.mining_graphs: on a card the warm-up captures the mining graph and
each timed call replays it), so the breakdown explains bench_train's
numbers at the same shapes.
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
from cim_tpu_torch.data.synthetic import make_microbatch, make_train_batch
from cim_tpu_torch.engine.train import Trainer, mine_pseudo_labels
from cim_tpu_torch.tools.stability_run import to_device
from cim_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", default=os.path.join(REPO, "configs", "resnet50_voc.yaml"))
    ap.add_argument("--n_valid", type=int, default=2000)
    ap.add_argument("--image_hw", type=int, nargs=2, default=(384, 512))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--set", dest="set_cfgs", nargs="+", default=None,
                    help="config key-value pairs, applied after the yaml")
    return ap.parse_args(argv)


def main(argv=None, log=print):
    """Run; returns {part: ms a call} (the full step: ms an image)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = clone_cfg(load_cfg(args.cfg))
    if args.set_cfgs:
        cfg_from_list(cfg, args.set_cfgs)
    cfg.TPU.DATA_PARALLEL = 1
    cfg.TPU.PALLAS_ROI_ALIGN = True  # the kernel's grid cap (4)
    accum = cfg.TPU.GRAD_ACCUM

    n_pad = proposal_bucket(cfg, args.n_valid)
    rng = np.random.RandomState(0)
    kw = dict(image_hw=tuple(args.image_hw), n_props=n_pad, n_valid=args.n_valid,
              num_classes=cfg.MODEL.NUM_CLASSES)
    trainer = Trainer(cfg, device=device, seed=0,
                      init_generator=torch.Generator(device=device).manual_seed(0))
    model, gen = trainer.model, trainer.generator
    mb = trainer.microbatch({k: v[None] for k, v in make_microbatch(rng, **kw).items()}, 0)
    im_hw = tuple(mb["image_hw"])

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = {}

    def timeit(name, fn, reps=args.iters, per=1):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        out[name] = (time.perf_counter() - t0) / reps / per * 1000
        log(f"{name:30s} {out[name]:8.1f} ms")

    def forward():
        return model(mb["image"], mb["rois"], mb["masks"], mb["valid"], im_hw=im_hw)

    with torch.no_grad():
        timeit("forward (model only)", forward)
        out0 = forward()
        timeit("mining x3 (cim_layer)", lambda: mine_pseudo_labels(
            cfg, out0, mb, gen, seed=0, graphs=trainer.mining_graphs))
        timeit("loss_fn (fwd+mine+losses)", lambda: trainer.loss_fn(mb, gen, 0))
    del out0

    def grad():
        trainer.loss_fn(mb, gen, 0)[0].backward()

    timeit("grad(loss_fn)", grad)
    model.zero_grad(set_to_none=True)

    batch = to_device({k: v[0] for k, v in make_train_batch(rng, 1, accum, **kw).items()},
                      device)
    timeit("full step / image", lambda: trainer.step(batch), reps=max(args.iters // 2, 1),
           per=accum)
    log(json.dumps({"device": str(device), "image_hw": list(args.image_hw),
                    "proposals": [args.n_valid, n_pad], "ms": out}))
    return out


if __name__ == "__main__":
    main()
