"""Training engine: loss assembly and the single-device train step
(port of cim_tpu/engine/train.py).

Loss assembly follows the reference's Generalized_RCNN.forward
(lib/modeling/model_builder.py:161-207), as cim_tpu does: K CIM branches
feeding cls / iou / bag losses (branch 0 weighted lmda = 3, iou x 3, each
gated on the branch having mined anything), plus the MIL bag loss and the
PCL loss. Gradient accumulation is the reference's iter_size loop
(tools/train.py:420-437): one backward per microbatch, gradients summed,
not divided; the logged losses are the per-microbatch mean.

Mining runs on the device without gradient; on a CUDA device each
microbatch's mining is one replay of a CUDA graph captured per proposal
bucket (mining.cim.MiningGraphs, owned by the Trainer). Its randomness
(anti-noise sampling) comes from one torch.Generator on the device,
reseeded for each (seed, step, microbatch, branch) and drawn before the
mining, so a resumed run draws what the uninterrupted one would have.

Data parallelism (cim_tpu's shard_map step, engine/train.py:218-288):
when a torch.distributed group exists (parallel.launch), the trainer
wraps its model in DistributedDataParallel. Each rank sums the gradients
of its microbatches, the first A - 1 under no_sync(), and the last
microbatch's backward all-reduces the sums; DDP's division by the world
size makes that cim_tpu's pmean of the per-rank sums, and every rank then
applies the same update. The logged metrics are the mean over ranks, all-
reduced on the device. Each rank draws its own anti-noise stream: with
more than one rank its seeds take the rank (cim_tpu folds the dp index
into its key). Without a group the step is the single-device one.
"""
from __future__ import annotations

import contextlib
import hashlib
import warnings
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from cim_tpu_torch import parallel
from cim_tpu_torch.engine.optimizer import lr_schedule, make_optimizer
from cim_tpu_torch.mining.cim import (MiningGraphs, MiningParams, PseudoLabels, draw_uniforms,
                                      mine_branches)
from cim_tpu_torch.mining.losses import cls_iou_loss, mil_bag_loss, pcl_loss
from cim_tpu_torch.models.builder import build_model
from cim_tpu_torch.utils.device import resolve_device
from cim_tpu_torch.utils.trace import span

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
                       graphs: MiningGraphs | None = None) -> List[PseudoLabels]:
    """CIM mining of every refine branch, without gradient: branch 0 mines
    from (predict_cls, predict_det), branch k from branch k-1's refine
    scores. With anti-noise sampling, branch k's uniforms are drawn from
    ``generator`` reseeded with derive_seed(seed, k), before the mining.
    With ``graphs`` (the Trainer's) and tensors on a CUDA device, the
    branches run as one CUDA graph replay (mining.cim.mine_branches)."""
    params = [mining_params_for_branch(cfg, k) for k in range(cfg.REFINE_TIMES)]
    sources = [(out["predict_cls"].detach(), out["predict_det"].detach())] + [
        (out["refine_cls"][k].detach(), out["refine_iou"][k].detach())
        for k in range(cfg.REFINE_TIMES - 1)]
    uniforms = [None] * len(params)
    for k, (p, (src_cls, src_det)) in enumerate(zip(params, sources)):
        if p.anti_noise:
            if generator is None:
                raise ValueError("anti-noise sampling needs a torch.Generator")
            generator.manual_seed(derive_seed(seed, k))
            uniforms[k] = draw_uniforms(src_cls, src_det, batch["labels"], p, generator)
    return mine_branches(sources, batch["labels"], batch["iou_map"], batch["asy_iou_map"],
                         batch["valid"], params, uniforms, graphs=graphs)


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


def make_loss_fn(cfg, model, graphs: MiningGraphs | None = None):
    """loss_fn(batch, generator, seed) -> (total, losses): the forward,
    mining through ``graphs``, then the losses of one image (cim_tpu
    compute_losses plus the total). batch: rois / masks / valid / labels /
    mat / iou_map / asy_iou_map on the device (the IoU maps may be float16
    and are upcast in the mining); batch["image_hw"], when present, is the
    host (h, w) of the image inside its zero-padded bucket."""

    def loss_fn(batch, generator=None, seed: int = 0):
        im_hw = batch.get("image_hw")
        with span("cim.forward"):
            out = model(batch["image"], batch["rois"], batch["masks"], batch["valid"],
                        im_hw=None if im_hw is None else (int(im_hw[0]), int(im_hw[1])))
        with span("cim.losses"):
            with span("cim.mining"):
                pseudo = mine_pseudo_labels(cfg, out, batch, generator, seed, graphs)
            losses = losses_from_pseudo_labels(cfg, out, batch, pseudo)
        return losses["total_loss"], losses

    return loss_fn


def metrics_to_floats(metrics) -> Dict[str, float]:
    """Trainer.step_async's metrics as floats, read from the device in
    one copy (the one wait for the step)."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    values = []
    if keys:
        stacked = torch.stack([metrics[k] for k in keys])
        with span("cim.sync"):
            values = stacked.tolist()
    out = dict(metrics)
    out.update(zip(keys, values))
    return out


class Trainer:
    """Model, optimizer and the train step on one device: the card unless
    the caller passes device="cpu". In a process group it is one rank of
    a data-parallel run (see the module's docstring): ``model`` stays the
    bare CIMModel, and ``ddp`` is its DistributedDataParallel wrapper (None
    without a group).

    step(batch) takes arrays with a leading GRAD_ACCUM axis (the layout of
    data.loader.TrainLoader and data.synthetic.make_train_batch with one
    device), moves each microbatch to the device, runs one forward and
    backward per microbatch, and applies one optimizer update at
    lr_schedule(step). It returns the per-microbatch mean of every loss
    metric and the LR, as floats. step_async(batch) runs the same step and
    returns the metrics as tensors on the device, without waiting for
    them. The phases, the uploads and the host's waits for the card are
    spans of utils.trace (cim.forward, cim.losses, cim.mining,
    cim.backward, cim.optimizer, cim.upload, cim.sync); without a profiler
    a span is one flag check.
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
        self.rank, self.world = parallel.rank(), parallel.world_size()
        self.ddp = None
        if dist.is_initialized():
            # frozen BN statistics never change: no buffer broadcast a step;
            # the gradients live in DDP's buckets, without a copy, as long
            # as step_async zeroes them in place
            with warnings.catch_warnings():  # newer PyTorch renames broadcast_buffers
                warnings.simplefilter("ignore", FutureWarning)
                self.ddp = torch.nn.parallel.DistributedDataParallel(
                    self.model, device_ids=[self.device] if self.device.type == "cuda" else None,
                    broadcast_buffers=False, gradient_as_bucket_view=True)
        # on a CUDA device each microbatch mines by one graph replay
        self.mining_graphs = MiningGraphs()
        self.loss_fn = make_loss_fn(cfg, self.ddp or self.model, self.mining_graphs)
        self.generator = torch.Generator(device=self.device)
        self.step_count = 0

    def load_weights(self, state_dict):
        """Load a model state_dict (e.g. utils.jax_weights.state_dict_from_jax)
        in place; the optimizer keeps its references to the parameters."""
        self.model.load_state_dict(state_dict, strict=True)

    def microbatch(self, batch, i):
        """Microbatch i of a step's batch, on the trainer's device
        (image_hw stays on the host). Tensors in pinned host memory (as
        data.loader.pin_batch leaves them) are copied with
        non_blocking=True: the copy queues on the stream and the host goes
        on. numpy arrays are copied from pageable memory, which holds the
        host until the copy is done."""
        mb = {}
        with span("cim.upload"):
            for k, v in batch.items():
                if k == "image_hw":
                    mb[k] = tuple(int(x) for x in v[i])
                elif isinstance(v, torch.Tensor):
                    mb[k] = v[i].to(self.device, non_blocking=True)
                else:
                    host = torch.from_numpy(np.ascontiguousarray(v[i]))
                    with span("cim.sync"):
                        mb[k] = host.to(self.device)
        return mb

    def step(self, batch) -> Dict[str, float]:
        return metrics_to_floats(self.step_async(batch))

    def step_async(self, batch) -> Dict[str, torch.Tensor | float]:
        """The step of :meth:`step`, without waiting for the card at its
        end: every loss metric as a 0-d tensor on the device, and "lr" as a
        float. Reading a metric waits for the step, so a training loop
        reads step i's after it has dispatched step i + 1. On a CUDA device
        the step never waits for the card: mining is a graph replay (a
        capture, the first time a key is seen, synchronizes once)."""
        accum = batch["labels"].shape[0]
        self.optimizer.zero_grad(set_to_none=self.ddp is None)
        sums = None
        for i in range(accum):
            # in a group, only the last microbatch's backward all-reduces
            # the gradients summed in .grad
            last = self.ddp is None or i == accum - 1
            with contextlib.nullcontext() if last else self.ddp.no_sync():
                total, losses = self.loss_fn(
                    self.microbatch(batch, i), self.generator, self.mining_seed(i))
                with span("cim.backward"):
                    total.backward()  # gradients sum over microbatches in .grad
            vals = torch.stack([v.detach().float() for v in losses.values()])
            sums = vals if sums is None else sums + vals
        means = sums / accum
        if self.ddp is not None:
            # gloo has no AVG: a sum, then the division, on the device
            dist.all_reduce(means)
            means = means / self.world
        lr = lr_schedule(self.cfg, self.step_count)
        with span("cim.optimizer"):
            self.optimizer.step(lr)
        self.step_count += 1
        metrics = dict(zip(losses.keys(), means.unbind()))
        metrics["lr"] = lr
        return metrics

    def mining_seed(self, microbatch: int) -> int:
        """The anti-noise seed of a microbatch of the next step: (seed,
        step, microbatch), and the rank when there is more than one."""
        ranks = (self.rank,) if self.world > 1 else ()
        return derive_seed(self.seed, self.step_count, microbatch, *ranks)
