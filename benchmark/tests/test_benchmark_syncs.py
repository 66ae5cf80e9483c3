"""On the card: every host sync of the benchmarked paths is a cim.sync span.

Under torch.cuda.set_sync_debug_mode("warn"), PyTorch warns at every
call that makes the host wait for the card (a read of a device value, a
copy from pageable host memory). One full-width Trainer.step and one
batched evaluation window, at a cell's shapes and warm, must warn exactly
as often as they record cim.sync spans, so that host_syncs.* counts every
sync. Run on a card with

    python -m pytest benchmark/tests/test_benchmark_syncs.py -m cuda -s

(-s prints where each sync was; it skips without a CUDA device).
"""
from __future__ import annotations

import importlib
import os
import traceback
import warnings
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import run

SEED = 2**33 + 15
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _caller(filename, lineno) -> str:
    """The warned line, and for a line of PyTorch's, the program's line
    that called it."""
    here = f"{os.path.relpath(filename, ROOT)}:{lineno}"
    if here.startswith("cim_tpu_torch"):
        return here
    ours = [f"{os.path.relpath(f.filename, ROOT)}:{f.lineno}" for f in traceback.extract_stack()]
    ours = [f for f in ours if f.startswith("cim_tpu_torch")]
    return f"{here} from {ours[-1]}" if ours else here


def _syncs_and_spans(fn):
    """(where each warned sync was, the cim.sync spans recorded) over fn()."""
    where = Counter()

    def note(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            where[_caller(filename, lineno)] += 1

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = note
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    return where, sum(e.name == "cim.sync" for e in prof.events())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["resnet50_voc.train_protocol", "resnet50_voc.eval_tta_b8"])
def test_every_host_sync_is_a_span(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, spec, traffic, _ = run.load_cell(cell)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    drv = driver.Driver(spec, traffic, SEED, torch.device("cuda"), print)
    if drv.kind == "train":
        drv.setup(warm=False)  # builds, and runs the checked steps: their shapes are warm
        batch = drv.pool[drv.checked[0]]["batch"]
        where, spans = _syncs_and_spans(lambda: drv.trainer.step(batch))
    else:
        drv.setup()  # every window once
        items = drv.windows[0]
        where, spans = _syncs_and_spans(
            lambda: drv.evaluator.im_detect_all_many(items, len(items)))
    print(f"{cell}: {sum(where.values())} syncs, {spans} cim.sync spans; where: "
          f"{dict(sorted(where.items()))}")
    assert sum(where.values()) == spans, where
    drv.free()
