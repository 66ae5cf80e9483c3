"""The host a run lands on, read for its log before and after the window
(``nvidia-smi`` and the process's own CPU clocks, all read only; nothing
is set).

A cell's rate follows the host where the card waits for the program's
dispatch or its host post-processing, so each run logs what can move it:
the CPUs the process may use, the CPU seconds of the whole process and of
its main thread (the dispatch) over the window, and the card's SM clock,
temperature and power. Nothing here runs inside the window.
"""
from __future__ import annotations

import os
import resource
import subprocess
import time


def process_seconds() -> float:
    """User+system CPU seconds of every thread of this process, ended ones too."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def card_state(index: int = 0) -> str:
    """The card's SM clock, its maximum, temperature, power and power limit."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--format=csv,noheader",
             "--query-gpu=clocks.sm,clocks.max.sm,temperature.gpu,power.draw,power.limit"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e!r}"
    return out.stdout.strip() or out.stderr.strip()[-200:]


class HostLog:
    """The card's state and the CPU seconds at start() and at stop(), both
    called on the main thread; report() gives the lines of the run's log."""

    def __init__(self, index: int = 0):
        self.index = index

    def start(self):
        self.card0 = card_state(self.index)
        self.cpu0, self.main0, self.wall0 = process_seconds(), time.thread_time(), time.perf_counter()

    def stop(self):
        self.cpu1, self.main1, self.wall1 = process_seconds(), time.thread_time(), time.perf_counter()
        self.card1 = card_state(self.index)

    def report(self) -> list:
        cpus = ",".join(str(c) for c in sorted(os.sched_getaffinity(0)))
        cpu, main = self.cpu1 - self.cpu0, self.main1 - self.main0
        return [f"process may use CPUs {cpus} of {os.cpu_count()}",
                f"card before the window: {self.card0}; after: {self.card1}",
                f"CPU s over the window's {self.wall1 - self.wall0:.2f} s: main thread "
                f"{main:.2f}, other threads {cpu - main:.2f}"]
