"""What the per-layer metric readers (``benchmark/metrics/<name>.py``)
share. Each reader takes the traced run's record and returns a number, or
None where the run has nothing for it to read: a run of another kind, a
run off the card, or a trace without the operations it reads.

A record holds ``kind`` (train or eval), ``on_card``, ``trace`` (a
benchmark.trace.Trace of the traced sub-window) and ``span`` (the
benchmark's span around each traced step or window), ``steps`` (traced
steps, or images), ``flops`` and ``seconds`` (the model FLOPs and the
seconds of the window outside the traced sub-window), ``peak_bytes``, and
the traced RoIAlign launches' least seconds and counts.
"""
from __future__ import annotations

from benchmark.flops import PEAK_BF16_FLOPS

ROI_FWD_KERNELS = r"\bfwd_(taps|slice)_kernel"
ROI_BWD_KERNELS = r"\bbwd_(taps|tile|sum)_kernel"


def _window(rec, kind):
    if rec.get("kind") != kind or not rec.get("on_card") or rec.get("trace") is None:
        return None
    return rec["trace"].window(rec["span"])


def host_ms(rec, kind: str, ranges) -> float | None:
    """Host ms a traced step inside the union of the named ranges."""
    win = _window(rec, kind)
    if win is None or not rec["steps"]:
        return None
    secs = rec["trace"].range_seconds(set(ranges), *win)
    return 1e3 * secs / rec["steps"] if secs > 0 else None


def mfu(rec, kind: str) -> float | None:
    """Model FLOPs of the window's untraced work over its seconds and the
    card's dense bf16 peak, in %."""
    if rec.get("kind") != kind or not rec.get("on_card") or not rec.get("seconds"):
        return None
    return 100.0 * rec["flops"] / (rec["seconds"] * PEAK_BF16_FLOPS) if rec["flops"] else None


def roofline(rec, kind: str, which: str) -> float | None:
    """The traced launches' least seconds over the device seconds of the
    kernels that run them, in %."""
    win = _window(rec, kind)
    if win is None:
        return None
    pattern = ROI_FWD_KERNELS if which == "fwd" else ROI_BWD_KERNELS
    secs = rec["trace"].kernel_seconds(pattern, *win)
    least = rec.get(f"roi_{which}_least_s", 0.0)
    if secs <= 0 or least <= 0:
        return None
    expected = rec.get("expected_launches")
    launches = rec.get(f"roi_{which}_launches")
    if expected is not None and launches != expected:
        return None  # the trace holds other launches than those counted
    return 100.0 * least / secs


def idle_pct(rec, kind: str) -> float | None:
    """The share of the traced sub-window with no device operation, in %."""
    win = _window(rec, kind)
    if win is None or win[1] <= win[0]:
        return None
    busy = rec["trace"].busy_seconds(*win)
    return 100.0 * (1.0 - busy / ((win[1] - win[0]) * 1e-6)) if busy > 0 else None


def peak_gib(rec, kind: str) -> float | None:
    """torch.cuda.max_memory_allocated() over the window, in GiB."""
    if rec.get("kind") != kind or not rec.get("on_card") or not rec.get("peak_bytes"):
        return None
    return rec["peak_bytes"] / 2**30
