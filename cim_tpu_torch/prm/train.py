"""PRM classifier training (port of cim_tpu/prm/train.py).

The published PRM recipe: FC-ResNet50 class response maps (the ordinary
conv backward), peak-stimulation aggregation (prm_modules.py
PeakStimulation, its backward routing the gradient to the peaks), the
multi-label soft-margin loss, SGD with momentum and weight decay over the
finetune() groups. cim_tpu's optax chain(add_decayed_weights, sgd(momentum))
is torch's SGD with weight_decay: decay on every parameter, the first
momentum buffer equal to the gradient. FrozenBatchNorm's scale and bias
train; its statistics never change.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cim_tpu_torch.prm.datasets import finetune_param_groups
from cim_tpu_torch.prm.model import FCResNet50
from cim_tpu_torch.prm.modules import peak_stimulation
from cim_tpu_torch.utils.device import no_tf32, resolve_device


def multilabel_soft_margin_loss(logits, targets):
    """torch.nn.MultiLabelSoftMarginLoss: the per-sample mean over classes
    of -[y log sigmoid(x) + (1 - y) log sigmoid(-x)], then the batch mean."""
    per = targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits)
    return -per.mean(dim=-1).mean()


class PRMClassifierTrainer:
    """Train FCResNet50 with peak-stimulation aggregation on ``device``.

    groups: finetune()'s {query: lr multiplier} over parameter names, e.g.
    the recipe's {'features': 0.01} (the backbone 100x slower than the
    classifier; cim_tpu's {'res': 0.01} names its flax scopes). The
    convolutions run in float32, TF32 off, whatever the process's flags."""

    def __init__(self, num_classes=20, base_lr=0.01, groups=None, momentum=0.9,
                 weight_decay=1e-4, win_size=3, device="cuda"):
        self.device = resolve_device(device)
        self.model = FCResNet50(num_classes, excitation=False).to(self.device)
        self.win_size = win_size
        self.optimizer = torch.optim.SGD(
            finetune_param_groups(self.model, base_lr, dict(groups or {"features": 0.01})),
            lr=base_lr, momentum=momentum, weight_decay=weight_decay)

    def _to_device(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
            if self.device.type == "cuda":
                x = x.pin_memory()  # a pageable copy would wait for the card's queue
        return x.to(self.device, torch.float32, non_blocking=True)

    def logits(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> (B, C) peak-aggregated class scores."""
        _, agg = peak_stimulation(self.model(images), self.win_size)
        return agg

    def step(self, images, targets) -> torch.Tensor:
        """One SGD step on a batch: images (B, H, W, 3) NHWC as
        datasets.iterate_batches gives them (numpy or a tensor), targets (B,
        C). Returns the loss on the device, without waiting for it."""
        x = self._to_device(images).permute(0, 3, 1, 2)
        t = self._to_device(targets)
        self.optimizer.zero_grad(set_to_none=True)
        with no_tf32():
            loss = multilabel_soft_margin_loss(self.logits(x), t)
            loss.backward()
        self.optimizer.step()
        return loss.detach()
