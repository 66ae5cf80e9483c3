"""The program's trace: named host ranges at its layer and host-device
boundaries, and the one profiler helper of its CLIs.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler runs, and a shared null context otherwise, so that a span costs
one flag check when nothing traces. The flag is the process-wide one that
``torch.profiler`` sets on start and clears on stop: it reads True on every
thread in between, also on a worker thread (``_AsyncPost``'s) that a
profiler built with ``profile_all_threads`` records, where the
thread-local ``torch._C._autograd._profiler_enabled()`` reads False. The
profiler puts the ranges and the card's activity on one clock.

The spans (every name starts with ``cim.``):

- ``cim.forward``, ``cim.losses`` (holding ``cim.mining``),
  ``cim.backward``, ``cim.optimizer``: the phases of a training step;
- ``cim.sync``: one point where the host waits for the card (a read of a
  device value, or a copy from pageable host memory), nested in whatever
  span is open there: a count of them is a count of queue drains;
- ``cim.upload``: putting a step's or a stack's inputs on the card;
- ``cim.mask_fuse``: the MaskFuse head (RoIAlign or RoIPool, the conv
  and the FCs), apart from the body;
- ``cim.eval.prepare``: the host padding and bucketing of one image;
- ``cim.eval.passes``: the dispatch of the TTA passes of an image or a
  stack;
- ``cim.eval.post``: the NMS and limit of one image on ``_AsyncPost``'s
  worker thread.

Beside the spans, counts of how often a mechanism engaged are attributes
of what engages, read as differences around a run: each hand-written
kernel's ``kernel_launches`` (ops/roi_align.py, ops/nms.py), and a
MiningGraphs' ``captures``, ``replays`` and ``eager_runs``
(mining/cim.py; the Trainer's is ``Trainer.mining_graphs``).
"""
from __future__ import annotations

import contextlib
import logging
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

logger = logging.getLogger(__name__)

SPANS = (
    "cim.forward", "cim.losses", "cim.mining", "cim.backward", "cim.optimizer",
    "cim.sync", "cim.upload", "cim.mask_fuse",
    "cim.eval.prepare", "cim.eval.passes", "cim.eval.post",
)

_NULL = contextlib.nullcontext()


def span(name: str):
    """A range named ``name`` (one of SPANS) while a profiler runs, else
    the shared null context."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _NULL


class Profile:
    """torch.profiler from construction to stop(): the trace goes to
    <profile_dir>/trace.json, and the card's busy share of the wall time
    to the log and the returned summary. all_threads: record ranges on
    every thread, also on threads started before the profiler (an
    executor's workers)."""

    def __init__(self, profile_dir, device, all_threads: bool = False):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        extra = {}
        if all_threads:
            extra["experimental_config"] = torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)
        self.dir, self.device = profile_dir, device
        self.prof = profile(activities=activities, **extra)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, **counts) -> dict:
        """Stop, write the trace, and return ``counts`` (what the window
        held, e.g. steps=5) with the window's wall and device-busy ms."""
        from torch.autograd import DeviceType

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall_ms = 1e3 * (time.perf_counter() - self.t0)
        self.prof.__exit__(None, None, None)
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, "trace.json")
        self.prof.export_chrome_trace(path)
        # kernels and copies only: the cim.* spans also appear as device
        # ranges, which span idle time
        busy_ms = sum(e.self_device_time_total for e in self.prof.key_averages()
                      if e.device_type == DeviceType.CUDA and not e.key.startswith("cim.")) / 1e3
        out = {**counts, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
               "idle_share": 1.0 - busy_ms / wall_ms if wall_ms > 0 else None, "trace": path}
        logger.info("profiler trace of %s written to %s: device busy %.1f of %.1f ms",
                    ", ".join(f"{v} {k}" for k, v in counts.items()), path, busy_ms, wall_ms)
        return out
