"""Training statistics, timers and logging.

Behavior contracts: lib/utils/training_stats.py (median-smoothed loss
window, iter_size inner accumulation), lib/utils/timer.py (tic/toc),
lib/utils/logging.py (structured json-ish stdout lines). TensorBoard
scalars are written with flax's summary writer when available.

The port's own copy of cim_tpu/engine/stats.py, without its jax.profiler
context manager (the port profiles with torch.profiler).
"""
from __future__ import annotations

import json
import logging
import time
from collections import defaultdict, deque

import numpy as np

logger = logging.getLogger(__name__)


class Timer:
    """tic/toc accumulator (reference lib/utils/timer.py:8-35)."""

    def __init__(self):
        self.reset()

    def tic(self):
        self.start_time = time.time()

    def toc(self, average=True):
        self.diff = time.time() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.average_time = self.total_time / self.calls
        return self.average_time if average else self.diff

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.average_time = 0.0


class SmoothedValue:
    """Median/average over a window (reference lib/utils/logging.py:60-83)."""

    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.series = []
        self.total = 0.0
        self.count = 0

    def add_value(self, value):
        value = float(value)
        self.deque.append(value)
        self.series.append(value)
        self.count += 1
        self.total += value

    def get_median_value(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    def get_average_value(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    def get_global_average_value(self):
        return self.total / max(self.count, 1)


class TrainingStats:
    """Median-smoothed per-loss tracking + periodic structured logging
    (reference lib/utils/training_stats.py:36-167)."""

    LOG_PERIOD = 20

    def __init__(self, disp_interval: int = 20, tb_writer=None, window: int = 20):
        self.disp_interval = disp_interval
        self.tb_writer = tb_writer
        self.iter_timer = Timer()
        self.smoothed_losses = defaultdict(lambda: SmoothedValue(window))
        self.smoothed_total = SmoothedValue(window)

    def iter_tic(self):
        self.iter_timer.tic()

    def iter_toc(self):
        return self.iter_timer.toc(average=False)

    def update_iter_stats(self, metrics: dict):
        for k, v in metrics.items():
            # losses + mining health metrics (mined_gt_k / fg_frac_k /
            # has_gt_k — see engine.train.losses_from_pseudo_labels) are all
            # median-smoothed and logged
            if k.endswith("loss") or k.startswith(("mined_gt", "fg_frac", "has_gt")):
                self.smoothed_losses[k].add_value(v)
        if "total_loss" in metrics:
            self.smoothed_total.add_value(metrics["total_loss"])

    def log_iter_stats(self, cur_iter: int, lr: float, max_iter: int | None = None,
                       force: bool = False):
        if not force and (cur_iter % self.disp_interval) != 0:
            return None
        stats = {
            "iter": int(cur_iter),
            "time": round(self.iter_timer.average_time, 4),
            "lr": float(lr),
            "loss": round(self.smoothed_total.get_median_value(), 6),
        }
        if max_iter:
            eta_s = self.iter_timer.average_time * (max_iter - cur_iter)
            stats["eta"] = time.strftime("%H:%M:%S", time.gmtime(eta_s))
        for k, v in self.smoothed_losses.items():
            stats[k] = round(v.get_median_value(), 6)
        logger.info(json.dumps(stats))
        if self.tb_writer is not None:
            for k, v in stats.items():
                if isinstance(v, (int, float)) and k != "iter":
                    self.tb_writer.scalar(k, v, cur_iter)
        return stats


def send_failure_email(subject: str, body: str, to: str, smtp_host="localhost"):
    """Email on expected-result regression (reference
    lib/utils/logging.py:86-92). No-op when no recipient configured."""
    if not to:
        return False
    import smtplib
    from email.mime.text import MIMEText

    try:
        msg = MIMEText(body)
        msg["Subject"] = subject
        msg["To"] = to
        with smtplib.SMTP(smtp_host) as s:
            s.sendmail("cim_tpu", [to], msg.as_string())
        return True
    except OSError as e:  # no smtp in most environments
        logger.warning("failure email not sent: %s", e)
        return False


def setup_logging(name=None, level=logging.INFO):
    fmt = "[%(asctime)s %(name)s]: %(message)s"
    logging.basicConfig(level=level, format=fmt)
    return logging.getLogger(name)
