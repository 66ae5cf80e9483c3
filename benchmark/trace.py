"""A traced sub-window: torch.profiler over CPU and CUDA, read back from
its Chrome trace into device intervals, host ranges and launches.

Host ranges are the program's ``cim.*`` labels and the benchmark's own
``bench.*`` spans around its calls. A device operation is named by the
innermost such range open when its launch was issued (on any thread: the
backward's kernels are launched from autograd's thread inside the main
thread's ``cim.backward``); an idle gap by the innermost range open at its
start.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RANGE_PREFIXES = ("cim.", "bench.")


class Profiler:
    """start() / stop() around the sub-window; stop() returns a Trace."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts, record_shapes=False,
                                            with_stack=False, profile_memory=False)

    def start(self):
        self._prof.start()

    def stop(self) -> "Trace":
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return Trace(events)


def short_name(name: str) -> str:
    """A kernel's name without 'void ', template arguments and parameters."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:96] or name[:96]


def union_seconds(intervals, lo=None, hi=None) -> float:
    """Length in seconds of the union of (start_us, end_us) intervals,
    clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


class Trace:
    def __init__(self, events):
        self.device = []  # (start, end, name, correlation)
        self.ranges = []  # (start, end, name)
        launch_at = {}
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat, ts, dur = ev.get("cat", ""), float(ev.get("ts", 0)), float(ev.get("dur", 0))
            args = ev.get("args") or {}
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, ev.get("name", ""), args.get("correlation")))
            elif cat == "user_annotation" and ev.get("name", "").startswith(RANGE_PREFIXES):
                self.ranges.append((ts, ts + dur, ev["name"]))
            elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
                launch_at[args["correlation"]] = ts
        self.launch_at = launch_at
        self.ranges.sort()

    def spans(self, name: str):
        return [(s, e) for s, e, n in self.ranges if n == name]

    def window(self, span: str):
        """(start_us, end_us) from the first to the last ``span``."""
        sp = self.spans(span)
        return (min(s for s, _ in sp), max(e for _, e in sp)) if sp else None

    def range_seconds(self, names, lo, hi) -> float:
        return union_seconds([(s, e) for s, e, n in self.ranges if n in names], lo, hi)

    def busy_seconds(self, lo, hi) -> float:
        return union_seconds([(s, e) for s, e, _, _ in self.device], lo, hi)

    def kernel_seconds(self, pattern: str, lo, hi) -> float:
        """Seconds of the device operations whose name matches."""
        rx = re.compile(pattern)
        return 1e-6 * sum(min(e, hi) - max(s, lo) for s, e, n, _ in self.device
                          if rx.search(n) and min(e, hi) > max(s, lo))

    def _innermost(self, t):
        best = None
        for s, e, n in self.ranges:
            if s > t:
                break
            if e >= t and (best is None or s >= best[0]):
                best = (s, e, n)
        return best[2] if best else "host"

    def breakdown(self, lo, hi, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps, each
        summed by name: operation as 'range:kernel', gap as the range the
        host was in."""
        ops = defaultdict(float)
        busy = []
        for s, e, n, corr in self.device:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            busy.append((s, e))
            where = self._innermost(self.launch_at.get(corr, s))
            ops[f"{where}:{short_name(n)}"] += (e - s) * 1e-6
        gaps = defaultdict(float)
        cur = lo
        for s, e in sorted(busy) + [(hi, hi)]:
            if s > cur:
                gaps[self._innermost(cur)] += (s - cur) * 1e-6
            cur = max(cur, e)
        def first(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": first(ops), "idle_gaps": first(gaps)}
