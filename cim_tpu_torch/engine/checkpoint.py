"""Checkpoints of the train state with torch.save (port of
cim_tpu/engine/checkpoint.py; reference tools/train.py save_ckpt :126-142
and resume :313-336).

Layout: <ckpt_dir>/model_step<step>.pth holding the model's state_dict
(parameters and the frozen BN statistics), the optimizer's buffers and
prev_lr, the trainer's seed and ``step``: the number of completed steps,
which is the index of the next step to run. A trainer loaded from it
continues the run: its LR schedule, momentum correction and per-step
generator seeds pick up where the saved one stopped. Evaluation reads the
model alone (load_model_weights). save_ckpt writes to a temporary file and
renames it, so a reader, wait_for_checkpoint's among them, never sees half
a checkpoint.

In a data-parallel run every rank calls save_ckpt and only rank 0 writes;
the others wait at a barrier until the file is there, so that no rank
moves on to read it, or to a step, before the write ends. Every rank
reads the same checkpoint. The model's state_dict is the bare module's
(Trainer.model, not its DistributedDataParallel wrapper), without a
``module.`` prefix: a snapshot of any world size loads at any other, in
test_net and in cim_tpu's converter.
"""
from __future__ import annotations

import logging
import os
import re
import time

import torch

from cim_tpu_torch import parallel

logger = logging.getLogger(__name__)

_NAME = re.compile(r"model_step(\d+)\.pth$")


def save_ckpt(ckpt_dir: str, trainer, extra: dict | None = None,
              sync: bool = True) -> str | None:
    """Write the trainer's state on rank 0; returns the file's path there,
    None on the other ranks. sync: in a group, end at a barrier (a crash
    save passes False: the other ranks may never reach it)."""
    if parallel.rank() != 0:
        if sync:
            parallel.barrier()
        return None
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
    if sync:
        parallel.barrier()
    return path


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir) if (m := _NAME.match(f))]
    return max(steps) if steps else None


def checkpoint_location(path: str):
    """A --load_ckpt argument as (directory, step): a model_step<n>.pth file
    names its step; a directory means its latest."""
    m = _NAME.match(os.path.basename(path))
    if m:
        return os.path.dirname(path), int(m.group(1))
    return path, None


def wait_for_checkpoint(ckpt_dir: str, poll_s: float = 10.0,
                        timeout_s: float | None = None) -> int:
    """Block until a checkpoint appears in ckpt_dir; returns its step
    (cim_tpu/engine/checkpoint.py:85; reference tools/test_net.py:156-163),
    so that evaluation can start before training has written a snapshot.
    Raises TimeoutError after timeout_s (None: wait forever)."""
    t0 = time.monotonic()
    while True:
        step = latest_step(ckpt_dir)
        if step is not None:
            return step
        if timeout_s is not None and time.monotonic() - t0 > timeout_s:
            raise TimeoutError(f"No checkpoint appeared in {ckpt_dir}")
        logger.info("Waiting for checkpoint in %s ...", ckpt_dir)
        time.sleep(poll_s)


def _checkpoint_file(ckpt_dir: str, step: int | None) -> str:
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"No checkpoint in {ckpt_dir}")
    return os.path.join(ckpt_dir, f"model_step{step}.pth")


def load_model_weights(ckpt_dir: str, model, step: int | None = None) -> int:
    """Load only the model's state_dict of the checkpoint at ``step``
    (default: the latest) into ``model`` (strict); returns the step. The
    tensors are read to the CPU and copied into the model where it lies;
    the optimizer's buffers, half of a training snapshot, are not moved."""
    payload = torch.load(_checkpoint_file(ckpt_dir, step), map_location="cpu",
                         weights_only=True)
    model.load_state_dict(payload["model"], strict=True)
    return int(payload["step"])


def load_ckpt(ckpt_dir: str, trainer, step: int | None = None) -> dict:
    """Restore the trainer (built for the same config) from ckpt_dir at
    ``step`` (default: the latest); returns the checkpoint's ``extra``."""
    payload = torch.load(_checkpoint_file(ckpt_dir, step), map_location=trainer.device,
                         weights_only=True)
    trainer.model.load_state_dict(payload["model"], strict=True)
    trainer.optimizer.load_state_dict(payload["optimizer"])
    trainer.step_count = int(payload["step"])
    trainer.seed = int(payload["seed"])
    return payload["extra"]
