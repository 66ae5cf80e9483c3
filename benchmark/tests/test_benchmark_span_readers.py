"""The readers of the program's spans (host_syncs.*, sync_wait_ms.train,
upload_host_ms.*, eval_prepare_host_ms.eval) on hand-made traces: a
benchmark.trace.Trace built from Chrome events, each number worked out
by hand, and None for a run off the card, a run of the other kind, and a
program that records no such span."""
from __future__ import annotations

import pytest

from benchmark import run
from benchmark.trace import Trace


def _range(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _kernel(ts, dur):
    return {"ph": "X", "cat": "kernel", "name": "void k<1>(int)", "ts": ts, "dur": dur,
            "args": {"correlation": 7}}


# two traced steps, [0, 1000] and [1100, 2000] us: the window is [0, 2000]
TRAIN = [
    _range("bench.step", 0, 1000), _range("bench.step", 1100, 900),
    _range("cim.upload", 10, 50), _range("cim.sync", 20, 10),  # a sync inside an upload
    _range("cim.forward", 60, 400), _range("cim.mask_fuse", 200, 100),
    _range("cim.mining", 500, 300), _range("cim.sync", 600, 40),
    _range("cim.upload", 1110, 80), _range("cim.sync", 1500, 60),
    _range("cim.sync", 2100, 10),  # after the window
    _kernel(300, 500),
]
# one traced window of 4 images, [0, 4000] us
EVAL = [
    _range("bench.eval_window", 0, 4000),
    _range("cim.eval.prepare", 0, 100), _range("cim.eval.prepare", 100, 60),
    _range("cim.eval.prepare", 2000, 40), _range("cim.eval.prepare", 2040, 40),
    _range("cim.upload", 200, 300), _range("cim.sync", 250, 100), _range("cim.sync", 350, 100),
    _range("cim.eval.passes", 500, 1000), _range("cim.sync", 1500, 300),
    _range("cim.upload", 2100, 100), _range("cim.sync", 2150, 50),
    _range("cim.eval.passes", 2200, 1000), _range("cim.sync", 3200, 700),
    _kernel(500, 3000),
]
# per step or image: train 2 steps, eval 4 images
WANT = {
    "host_syncs.train": ("train", 3 / 2),
    "sync_wait_ms.train": ("train", (10 + 40 + 60) / 1e3 / 2),
    "upload_host_ms.train": ("train", (50 + 80) / 1e3 / 2),
    "host_syncs.eval": ("eval", 5 / 4),
    "upload_host_ms.eval": ("eval", (300 + 100) / 1e3 / 4),
    "eval_prepare_host_ms.eval": ("eval", (100 + 60 + 40 + 40) / 1e3 / 4),
}


def _rec(kind, events, on_card=True):
    return {"kind": kind, "on_card": on_card, "trace": Trace(events),
            "span": "bench.step" if kind == "train" else "bench.eval_window",
            "steps": 2 if kind == "train" else 4}


@pytest.mark.parametrize("metric", sorted(WANT))
def test_a_reader_gives_the_number_worked_out_by_hand(metric):
    kind, want = WANT[metric]
    read = run.reader(metric)
    assert read(_rec(kind, TRAIN if kind == "train" else EVAL)) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_a_reader_gives_none_where_it_has_nothing_to_read(metric):
    kind, _ = WANT[metric]
    events = TRAIN if kind == "train" else EVAL
    other = "eval" if kind == "train" else "train"
    read = run.reader(metric)
    assert read(_rec(kind, events, on_card=False)) is None
    assert read(_rec(other, EVAL if kind == "train" else TRAIN)) is None
    # an older program: the benchmark's span and the kernel, no program span
    bare = [e for e in events if not e["name"].startswith("cim.")]
    assert read(_rec(kind, bare)) is None
    assert read({**_rec(kind, events), "trace": None}) is None
