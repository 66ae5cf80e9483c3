#!/usr/bin/env python3
"""How far rounding-sized changes move the port's float32 train step, on the CPU.

    PYTHONPATH=. python scripts/torch_grad_sensitivity.py

chip_smoke.py's train_reference phase holds the card against the CPU on
one full-width float32 microbatch (a 128x160 image, 64 proposals) with
random weights. This script measures, on the CPU alone, the two effects
that set its tolerances:

- mining: relative noise of size eps on the heads' scores, and whether
  the mined pseudo-GT counts change (near-ties in the sorts and argmaxes);
- gradients: relative noise of size eps on every weight, with the pseudo
  labels held fixed, and the largest change of a Box_Head or
  Conv_Body.res4 gradient tensor, in norm and in its largest element
  (ReLU units within rounding of zero switch).

It prints one line per eps. It needs no GPU and takes a minute or two.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from cim_tpu_torch.config import load_cfg
from cim_tpu_torch.data.synthetic import make_microbatch
from cim_tpu_torch.engine.train import Trainer, losses_from_pseudo_labels, mine_pseudo_labels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRIALS = 5


def main():
    cfg = load_cfg(os.path.join(REPO, "configs", "resnet50_voc.yaml"))
    cfg.TPU.PALLAS_ROI_ALIGN = True
    cfg.TPU.PRECISION = "f32"
    cfg.TPU.GRAD_ACCUM = 1
    cfg.Anti_noise_sampling = False
    mb = make_microbatch(np.random.RandomState(2), image_hw=(128, 160), n_props=64,
                         n_valid=60, num_classes=cfg.MODEL.NUM_CLASSES)
    trainer = Trainer(cfg, device="cpu", init_generator=torch.Generator().manual_seed(3))
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    batch = trainer.microbatch({k: v[None] for k, v in mb.items()}, 0)

    def forward():
        return trainer.model(batch["image"], batch["rois"], batch["masks"], batch["valid"],
                             im_hw=batch["image_hw"])

    def grads(pseudo, eps):
        trainer.model.load_state_dict(state)
        trainer.optimizer.zero_grad()
        if eps:
            gen = torch.Generator().manual_seed(5)
            with torch.no_grad():
                for p in trainer.model.parameters():
                    p.mul_(1 + eps * torch.randn(p.shape, generator=gen))
        losses_from_pseudo_labels(cfg, forward(), batch, pseudo)["total_loss"].backward()
        return {n: p.grad.clone() for n, p in trainer.model.named_parameters()
                if n.startswith(("Box_Head.", "Conv_Body.res4."))}

    with torch.no_grad():
        out = forward()
        base = [int(p.gt_count) for p in mine_pseudo_labels(cfg, out, batch)]
    pseudo = mine_pseudo_labels(cfg, out, batch)
    g0 = grads(pseudo, 0.0)
    for eps in (1e-6, 1e-5):
        flips = 0
        with torch.no_grad():
            for t in range(TRIALS):
                gen = torch.Generator().manual_seed(t)
                noisy = {k: v * (1 + eps * torch.randn(v.shape, generator=gen))
                         for k, v in out.items()}
                flips += [int(p.gt_count) for p in mine_pseudo_labels(cfg, noisy, batch)] != base
        g1 = grads(pseudo, eps)
        norm = max(((g1[n] - g0[n]).norm() / g0[n].norm()).item() for n in g0)
        elem = max(((g1[n] - g0[n]).abs().max() / g0[n].abs().max()).item() for n in g0)
        print(f"eps {eps:g}: mined counts changed in {flips} of {TRIALS} noisy draws "
              f"(base {base}); gradients moved by up to {norm:.3g} in norm and "
              f"{elem:.3g} in their largest element", flush=True)


if __name__ == "__main__":
    main()
