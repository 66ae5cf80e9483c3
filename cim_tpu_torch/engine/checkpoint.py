"""Checkpoints of the train state with torch.save (port of
cim_tpu/engine/checkpoint.py; reference tools/train.py save_ckpt :126-142
and resume :313-336).

Layout: <ckpt_dir>/model_step<step>.pth holding the model's state_dict
(parameters and the frozen BN statistics), the optimizer's buffers and
prev_lr, the trainer's seed and ``step``: the number of completed steps,
which is the index of the next step to run. A trainer loaded from it
continues the run: its LR schedule, momentum correction and per-step
generator seeds pick up where the saved one stopped.
"""
from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r"model_step(\d+)\.pth$")


def save_ckpt(ckpt_dir: str, trainer, extra: dict | None = None) -> str:
    """Write the trainer's state; returns the file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"model_step{trainer.step_count}.pth")
    payload = {
        "model": trainer.model.state_dict(),
        "optimizer": trainer.optimizer.state_dict(),
        "step": trainer.step_count,
        "seed": trainer.seed,
        "extra": extra or {},
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # a reader never sees half a checkpoint
    return path


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir) if (m := _NAME.match(f))]
    return max(steps) if steps else None


def load_ckpt(ckpt_dir: str, trainer, step: int | None = None) -> dict:
    """Restore the trainer (built for the same config) from ckpt_dir at
    ``step`` (default: the latest); returns the checkpoint's ``extra``."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"No checkpoint in {ckpt_dir}")
    payload = torch.load(os.path.join(ckpt_dir, f"model_step{step}.pth"),
                         map_location=trainer.device, weights_only=True)
    trainer.model.load_state_dict(payload["model"], strict=True)
    trainer.optimizer.load_state_dict(payload["optimizer"])
    trainer.step_count = int(payload["step"])
    trainer.seed = int(payload["seed"])
    return payload["extra"]
