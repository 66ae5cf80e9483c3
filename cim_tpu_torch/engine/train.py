"""Training engine: loss assembly and the single-device train step
(port of cim_tpu/engine/train.py).

Loss assembly follows the reference's Generalized_RCNN.forward
(lib/modeling/model_builder.py:161-207), as cim_tpu does: K CIM branches
feeding cls / iou / bag losses (branch 0 weighted lmda = 3, iou x 3, each
gated on the branch having mined anything), plus the MIL bag loss and the
PCL loss. Gradient accumulation is the reference's iter_size loop
(tools/train.py:420-437): one backward per microbatch, gradients summed,
not divided; the logged losses are the per-microbatch mean.

Mining runs on the device without gradient. Its randomness (anti-noise
sampling) comes from one torch.Generator on the device, reseeded for each
(seed, step, microbatch, branch), so a resumed run draws what the
uninterrupted one would have. Multi-device data parallelism is not ported.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from cim_tpu_torch.engine.optimizer import lr_schedule, make_optimizer
from cim_tpu_torch.mining.cim import MiningParams, PseudoLabels, cim_layer
from cim_tpu_torch.mining.losses import cls_iou_loss, mil_bag_loss, pcl_loss
from cim_tpu_torch.models.builder import build_model
from cim_tpu_torch.utils.device import resolve_device

LOSS_KEYS = ("bag_loss", "pcl_loss", "cls_loss", "iou_loss")


def mining_params_for_branch(cfg, k: int) -> MiningParams:
    """Threshold ramp per refine branch (reference model_builder.py:90-94)."""
    return MiningParams(
        p_seed=cfg.p_seed,
        cls_thr=0.25 + cfg.step_rate * k,
        iou_thr=0.5 + cfg.step_rate * k,
        con_thr=cfg.adj_thr,
        anti_noise=cfg.Anti_noise_sampling,
        class_budget=int(cfg.TPU.MINING_CLASS_BUDGET),
    )


def derive_seed(*parts: int) -> int:
    """A 63-bit generator seed from integers (seed, step, microbatch,
    branch): distinct tuples give unrelated seeds."""
    digest = hashlib.sha256(repr(tuple(int(p) for p in parts)).encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def mine_pseudo_labels(cfg, out, batch, generator=None, seed: int = 0,
                       nms_rounds=None) -> List[PseudoLabels]:
    """CIM mining of every refine branch, without gradient: branch 0 mines
    from (predict_cls, predict_det), branch k from branch k-1's refine
    scores. With anti-noise sampling, branch k draws from ``generator``
    reseeded with derive_seed(seed, k)."""
    labels = batch["labels"].float()
    iou_map = batch["iou_map"].float()
    asy_iou_map = batch["asy_iou_map"].float()
    pseudo = []
    for k in range(cfg.REFINE_TIMES):
        params_k = mining_params_for_branch(cfg, k)
        if k == 0:
            src_cls, src_det = out["predict_cls"], out["predict_det"]
        else:
            src_cls, src_det = out["refine_cls"][k - 1], out["refine_iou"][k - 1]
        if params_k.anti_noise:
            if generator is None:
                raise ValueError("anti-noise sampling needs a torch.Generator")
            generator.manual_seed(derive_seed(seed, k))
        with torch.no_grad():
            pseudo.append(cim_layer(src_cls.detach(), src_det.detach(), labels, iou_map,
                                    asy_iou_map, batch["valid"], params_k,
                                    generator=generator, nms_rounds=nms_rounds))
    return pseudo


def losses_from_pseudo_labels(cfg, out, batch, pseudo) -> Dict[str, torch.Tensor]:
    """The four training losses of one image given each branch's mined
    pseudo labels, and the mining health metrics."""
    labels = batch["labels"].float()
    valid = batch["valid"]
    predict_cls, predict_det = out["predict_cls"], out["predict_det"]
    zero = torch.zeros((), dtype=torch.float32, device=labels.device)
    losses = {
        "bag_loss": mil_bag_loss(predict_cls, predict_det, labels, valid),
        "pcl_loss": pcl_loss(predict_cls, batch["mat"], labels, valid,
                             max_clusters=cfg.TPU.MAX_CLUSTERS),
        "cls_loss": zero,
        "iou_loss": zero,
    }
    n_valid = valid.float().sum().clamp(min=1.0)
    for k, pl in enumerate(pseudo):
        lmda = 3.0 if k == 0 else 1.0
        c_l, i_l, b_l = cls_iou_loss(
            out["refine_cls"][k], out["refine_iou"][k], pl.pseudo_labels,
            pl.pseudo_iou_labels, lmda * pl.loss_weights, labels, valid,
        )
        gate = pl.has_gt.float()
        losses["cls_loss"] = losses["cls_loss"] + gate * c_l
        losses["iou_loss"] = losses["iou_loss"] + gate * 3.0 * i_l
        losses["bag_loss"] = losses["bag_loss"] + gate * b_l

        # mining health metrics (no reference counterpart): mined-GT count,
        # fg fraction of the valid proposals, branch-found-anything rate
        losses[f"mined_gt_{k}"] = pl.gt_count.float()
        losses[f"fg_frac_{k}"] = pl.pseudo_labels[:, 1:].sum() / n_valid
        losses[f"has_gt_{k}"] = gate
    # only the four losses sum into the objective; the rest are metrics
    losses["total_loss"] = sum(losses[k] for k in LOSS_KEYS)
    return losses


def compute_losses(cfg, out, batch, generator=None, seed: int = 0,
                   nms_rounds=None) -> Dict[str, torch.Tensor]:
    """Mining, then the losses, of one image (cim_tpu compute_losses plus
    the total). batch: rois / masks / valid / labels / mat / iou_map /
    asy_iou_map on the device; the IoU maps may be float16 and are upcast
    here."""
    with record_function("cim.mining"):
        pseudo = mine_pseudo_labels(cfg, out, batch, generator, seed, nms_rounds)
    return losses_from_pseudo_labels(cfg, out, batch, pseudo)


def make_loss_fn(cfg, model):
    """loss_fn(batch, generator, seed, nms_rounds) -> (total, losses).
    batch["image_hw"], when present, is the host (h, w) of the image
    inside its zero-padded bucket."""

    def loss_fn(batch, generator=None, seed: int = 0, nms_rounds=None):
        im_hw = batch.get("image_hw")
        with record_function("cim.forward"):
            out = model(batch["image"], batch["rois"], batch["masks"], batch["valid"],
                        im_hw=None if im_hw is None else (int(im_hw[0]), int(im_hw[1])))
        with record_function("cim.losses"):
            losses = compute_losses(cfg, out, batch, generator, seed, nms_rounds)
        return losses["total_loss"], losses

    return loss_fn


class Trainer:
    """Model, optimizer and the train step on one device: the card unless
    the caller passes device="cpu".

    step(batch) takes numpy arrays with a leading GRAD_ACCUM axis (the
    layout of data.loader.TrainLoader and data.synthetic.make_train_batch
    with one device), moves each microbatch to the device, runs one
    forward and backward per microbatch, and applies one optimizer update
    at lr_schedule(step). It returns the per-microbatch mean of every loss
    metric and the LR, as floats. The phases are labelled for
    torch.profiler (cim.forward, cim.losses, cim.mining, cim.backward,
    cim.optimizer); without a profiler a label is one range push and
    pop per phase.
    """

    def __init__(self, cfg, device="cuda", seed: int = 0,
                 init_generator: torch.Generator | None = None):
        """init_generator: draw the conv and linear weights from it
        (PyTorch's default init); else load weights with load_weights."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seed = int(seed)
        self.model = build_model(cfg, device=self.device, generator=init_generator,
                                 train=True)
        self.optimizer = make_optimizer(
            cfg, [(n, p) for n, p in self.model.named_parameters() if p.requires_grad])
        self.loss_fn = make_loss_fn(cfg, self.model)
        self.generator = torch.Generator(device=self.device)
        self.step_count = 0
        self.last_nms_rounds: list = []  # NMS rounds of the last step's minings

    def load_weights(self, state_dict):
        """Load a model state_dict (e.g. utils.jax_weights.state_dict_from_jax)
        in place; the optimizer keeps its references to the parameters."""
        self.model.load_state_dict(state_dict, strict=True)

    def microbatch(self, batch, i):
        """Microbatch i of a step's numpy batch, on the trainer's device
        (image_hw stays on the host)."""
        mb = {k: torch.from_numpy(np.ascontiguousarray(v[i])).to(self.device)
              for k, v in batch.items() if k != "image_hw"}
        if "image_hw" in batch:
            mb["image_hw"] = tuple(int(x) for x in batch["image_hw"][i])
        return mb

    def step(self, batch) -> Dict[str, float]:
        accum = batch["labels"].shape[0]
        self.optimizer.zero_grad()
        self.last_nms_rounds = []
        sums = None
        for i in range(accum):
            total, losses = self.loss_fn(
                self.microbatch(batch, i), self.generator,
                derive_seed(self.seed, self.step_count, i), self.last_nms_rounds)
            with record_function("cim.backward"):
                total.backward()  # gradients sum over microbatches in .grad
            vals = torch.stack([v.detach().float() for v in losses.values()])
            sums = vals if sums is None else sums + vals
        lr = lr_schedule(self.cfg, self.step_count)
        with record_function("cim.optimizer"):
            self.optimizer.step(lr)
        self.step_count += 1
        metrics = dict(zip(losses.keys(), (sums / accum).tolist()))
        metrics["lr"] = lr
        return metrics
