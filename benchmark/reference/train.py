"""The training step in plain PyTorch: GRAD_ACCUM microbatches of one
image each, each one forward, CIM mining of every refine branch, the
objective and one backward (gradients summed, not divided), then one SGD
update (reference tools/train.py: torch SGD with momentum, weight decay,
biases at twice the LR without decay, a linear warm-up, the momentum
scaled when the LR moves by more than a threshold ratio).
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.losses import image_loss
from benchmark.reference.mining import derive_seed, mine_branch


def lr_at(solver: dict, step: int) -> float:
    """steps_with_decay with linear warm-up, in float32."""
    f32 = np.float32
    s = f32(step)
    decays = f32(sum(1 for b in solver["STEPS"][1:] if s >= b))
    lr = f32(solver["BASE_LR"]) * f32(solver["GAMMA"]) ** decays
    if solver["WARM_UP_ITERS"] > 0 and s < solver["WARM_UP_ITERS"]:
        alpha = s / f32(solver["WARM_UP_ITERS"])
        factor = f32(solver["WARM_UP_FACTOR"]) * (f32(1.0) - alpha) + alpha
        lr = f32(solver["BASE_LR"]) * f32(factor)
    return float(f32(lr))


class SGD:
    def __init__(self, named_params, solver: dict):
        self.params = [(n, p) for n, p in named_params if p.requires_grad]
        self.solver = solver
        self.buf = [torch.zeros_like(p) for _, p in self.params]
        self.prev_lr = 0.0

    def _correction(self, lr):
        f32, eps = np.float32, np.float32(1e-10)
        lr, prev = f32(lr), f32(self.prev_lr)
        ratio = max(lr / max(prev, eps), prev / max(lr, eps))
        if prev > f32(1e-7) and ratio > f32(self.solver["SCALE_MOMENTUM_THRESHOLD"]):
            return float(lr / max(prev, eps))
        return 1.0

    @torch.no_grad()
    def step(self, lr: float):
        corr = self._correction(lr)
        wd, mu = self.solver["WEIGHT_DECAY"], self.solver["MOMENTUM"]
        for (name, p), v in zip(self.params, self.buf):
            bias = name.rsplit(".", 1)[-1] == "bias"
            decay = wd if not bias or self.solver["BIAS_WEIGHT_DECAY"] else 0.0
            mult = 2.0 if bias and self.solver["BIAS_DOUBLE_LR"] else 1.0
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if corr != 1.0:
                v.mul_(corr)
            v.mul_(mu).add_(g + decay * p)
            p.sub_(float(np.float32(lr) * np.float32(mult)) * v)
        self.prev_lr = lr


def microbatch_loss(model, mb: dict, cfg: dict, mining_seed: int, generator):
    """The objective of one microbatch at its true sizes. mb holds the
    program's input layout for one image: image (Hb, Wb, 3) in its bucket,
    image_hw, rois / masks / mat (N_pad, ...), valid (N_pad,), labels,
    iou_map / asy_iou_map (N_pad, N_pad) float16."""
    h, w = (int(x) for x in mb["image_hw"])
    n_pad = int(mb["valid"].shape[0])
    n = int(mb["valid"].sum())
    out = model(mb["image"][:h, :w].float(), mb["rois"][:n].float(), mb["masks"][:n].float())
    labels = mb["labels"].float()
    iou = mb["iou_map"][:n, :n].float()
    asy = mb["asy_iou_map"][:n, :n].float()
    pseudo = []
    with torch.no_grad():
        for k in range(cfg["REFINE_TIMES"]):
            src = ((out["predict_cls"], out["predict_det"]) if k == 0
                   else (out["refine_cls"][k - 1], out["refine_iou"][k - 1]))
            generator.manual_seed(derive_seed(mining_seed, k))
            pseudo.append(mine_branch(src[0].detach(), src[1].detach(), labels, iou, asy,
                                      n_pad, k, cfg, generator))
    return image_loss(out, labels, mb["mat"][:n], pseudo, cfg["MAX_CLUSTERS"])


def train_steps(model, batches, cfg: dict, trainer_seed: int, generator, microbatch_of=None):
    """Run one SGD step on each batch (a dict of (GRAD_ACCUM, ...) arrays
    on the model's device) from the model's current weights. Returns the
    step losses (mean total over microbatches), the summed gradient of the
    first step by parameter name, and the optimizer. microbatch_of(i)
    names the microbatch that runs in place of microbatch i (a fault the
    control test plants)."""
    opt = SGD(model.named_parameters(), cfg["SOLVER"])
    losses, first_grad = [], None
    for step, batch in enumerate(batches):
        for _, p in opt.params:
            p.grad = None
        accum = int(batch["labels"].shape[0])
        total = 0.0
        for i in range(accum):
            src = i if microbatch_of is None else microbatch_of(i)
            mb = {k: v[src] for k, v in batch.items()}
            loss, _ = microbatch_loss(model, mb, cfg, derive_seed(trainer_seed, step, i),
                                      generator)
            loss.backward()
            total += float(loss.detach())
        losses.append(total / accum)
        if step == 0:
            first_grad = {n: (p.grad.detach().clone() if p.grad is not None
                              else torch.zeros_like(p)) for n, p in opt.params}
        opt.step(lr_at(cfg["SOLVER"], step))
    return losses, first_grad, opt
