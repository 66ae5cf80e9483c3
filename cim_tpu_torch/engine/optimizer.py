"""SGD / Adam and the LR schedule (port of cim_tpu/engine/optimizer.py).

Reference contracts, as in cim_tpu:
- parameter groups: a parameter whose leaf name is "bias" (FrozenBN's
  bias included, as named_parameters gives it) gets 2x LR
  (SOLVER.BIAS_DOUBLE_LR) and no weight decay unless
  SOLVER.BIAS_WEIGHT_DECAY (tools/train.py:282-311);
- torch SGD update: d = g + wd * p; v = mu * v + d; p -= lr * v;
- momentum correction: when the LR changes by a ratio above
  SCALE_MOMENTUM_THRESHOLD, the buffer is scaled by new_lr / old_lr
  (lib/utils/net.py:47-84), never on the first step (prev_lr 0);
- frozen parameters (requires_grad False: FREEZE_AT stages, or the whole
  body under FREEZE_CONV_BODY) are not in the optimizer and never move;
- schedule: steps_with_decay with linear or constant warmup
  (tools/train.py:389-416).

The LR and the momentum-correction factor are computed in float32, as
cim_tpu computes them; the updates run in place on the parameters.
"""
from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np
import torch

NamedParams = Iterable[Tuple[str, torch.Tensor]]


def lr_schedule(cfg, step: int) -> float:
    """steps_with_decay + warmup at ``step``, in float32."""
    f32 = np.float32
    base = f32(cfg.SOLVER.BASE_LR)
    s = f32(step)
    decays = f32(sum(1 for b in list(cfg.SOLVER.STEPS)[1:] if s >= b))
    lr = base * f32(cfg.SOLVER.GAMMA) ** decays
    warm = cfg.SOLVER.WARM_UP_ITERS
    if warm > 0 and s < warm:
        if cfg.SOLVER.WARM_UP_METHOD == "linear":
            alpha = s / f32(warm)
            factor = f32(cfg.SOLVER.WARM_UP_FACTOR) * (f32(1.0) - alpha) + alpha
        elif cfg.SOLVER.WARM_UP_METHOD == "constant":
            factor = f32(cfg.SOLVER.WARM_UP_FACTOR)
        else:
            raise KeyError(f"Unknown SOLVER.WARM_UP_METHOD: {cfg.SOLVER.WARM_UP_METHOD}")
        # the reference's warmup sets BASE_LR * factor and ignores decay
        lr = base * f32(factor)
    return float(f32(lr))


def is_bias(name: str) -> bool:
    return name.rsplit(".", 1)[-1] == "bias"


class _Optimizer:
    def __init__(self, cfg, named_params: NamedParams):
        self.params: List[Tuple[str, torch.Tensor]] = list(named_params)
        self.wd = float(cfg.SOLVER.WEIGHT_DECAY)
        self.bias_wd = self.wd if cfg.SOLVER.BIAS_WEIGHT_DECAY else 0.0
        self.bias_mult = 2.0 if cfg.SOLVER.BIAS_DOUBLE_LR else 1.0
        self.prev_lr = 0.0

    def _group(self, name):
        """(weight decay, LR multiplier) of a parameter."""
        return (self.bias_wd, self.bias_mult) if is_bias(name) else (self.wd, 1.0)

    def zero_grad(self):
        for _, p in self.params:
            p.grad = None

    def _buffers(self):
        raise NotImplementedError

    def state_dict(self) -> dict:
        return {"prev_lr": self.prev_lr,
                **{k: [b.clone() for b in v] for k, v in self._buffers().items()}}

    def load_state_dict(self, state: dict):
        self.prev_lr = float(state["prev_lr"])
        for k, bufs in self._buffers().items():
            if len(state[k]) != len(bufs):
                raise ValueError(f"optimizer state {k!r}: {len(state[k])} buffers for "
                                 f"{len(bufs)} parameters")
            for b, s in zip(bufs, state[k]):
                b.copy_(s)


class SGD(_Optimizer):
    """torch SGD with the reference's momentum correction
    (cim_tpu make_sgd)."""

    def __init__(self, cfg, named_params: NamedParams):
        super().__init__(cfg, named_params)
        self.momentum = float(cfg.SOLVER.MOMENTUM)
        self.scale_momentum = bool(cfg.SOLVER.SCALE_MOMENTUM)
        self.scale_thr = np.float32(cfg.SOLVER.SCALE_MOMENTUM_THRESHOLD)
        self.buf = [torch.zeros_like(p) for _, p in self.params]

    def _buffers(self):
        return {"momentum": self.buf}

    def correction(self, lr: float) -> float:
        """new/old LR when the LR moved by more than the threshold ratio,
        else 1 (float32, as cim_tpu)."""
        f32, eps = np.float32, np.float32(1e-10)
        lr, prev = f32(lr), f32(self.prev_lr)
        if not self.scale_momentum:
            return 1.0
        ratio = max(lr / max(prev, eps), prev / max(lr, eps))
        if prev > f32(1e-7) and ratio > self.scale_thr:
            return float(lr / max(prev, eps))
        return 1.0

    @torch.no_grad()
    def step(self, lr: float):
        corr = self.correction(lr)
        for (name, p), v in zip(self.params, self.buf):
            decay, mult = self._group(name)
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if corr != 1.0:
                v.mul_(corr)
            v.mul_(self.momentum).add_(g + decay * p)
            p.sub_(float(np.float32(lr) * np.float32(mult)) * v)
        self.prev_lr = lr


class Adam(_Optimizer):
    """torch.optim.Adam semantics with the reference's groups (cim_tpu
    make_adam): bias-corrected moments, L2 term added to the gradient."""

    def __init__(self, cfg, named_params: NamedParams, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(cfg, named_params)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for _, p in self.params]
        self.nu = [torch.zeros_like(p) for _, p in self.params]
        self.count = 0

    def _buffers(self):
        return {"mu": self.mu, "nu": self.nu}

    def state_dict(self) -> dict:
        return {**super().state_dict(), "count": self.count}

    def load_state_dict(self, state: dict):
        super().load_state_dict(state)
        self.count = int(state["count"])

    @torch.no_grad()
    def step(self, lr: float):
        f32 = np.float32
        self.count += 1
        c1 = float(f32(1.0) - f32(self.b1) ** f32(self.count))
        c2 = float(f32(1.0) - f32(self.b2) ** f32(self.count))
        for (name, p), m, v in zip(self.params, self.mu, self.nu):
            decay, mult = self._group(name)
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            d = g + decay * p
            m.mul_(self.b1).add_((1 - self.b1) * d)
            v.mul_(self.b2).add_((1 - self.b2) * d * d)
            upd = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            p.sub_(float(f32(lr) * f32(mult)) * upd)
        self.prev_lr = lr


def make_optimizer(cfg, named_params: NamedParams) -> _Optimizer:
    """SOLVER.TYPE dispatch (reference tools/train.py:308-311) over the
    trainable (name, parameter) pairs."""
    if cfg.SOLVER.TYPE == "SGD":
        return SGD(cfg, named_params)
    if cfg.SOLVER.TYPE == "Adam":
        return Adam(cfg, named_params)
    raise ValueError(f"Unknown SOLVER.TYPE: {cfg.SOLVER.TYPE}")
