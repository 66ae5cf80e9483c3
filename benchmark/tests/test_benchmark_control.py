"""The control: the plain reference put in the program's place one
precision below the configuration's (fp8 e4m3 operands for the bf16 body
and MaskFuse) must come out not correct under each cell's limits, while
the program comes out correct; and so must the planted faults the control
script reads. On the CPU at the tiny size; on the card, at each cell's own
size (``python -m pytest benchmark/tests -m cuda`` there)."""
from __future__ import annotations

import pytest
import torch

from benchmark import run
from benchmark.control import readings
from benchmark.tests.tiny import TINY_CFG, tiny_cell

CELLS = ["resnet50_voc.train_protocol", "vgg16_voc.eval_tta_b8"]


def _judge(numbers, limits):
    return run.judge(numbers, limits)[1]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_tiny_size(name):
    torch.set_num_threads(2)
    _, _, spec, traffic, limits = tiny_cell(name)
    r = readings(spec, traffic, 2**34 + 1, 1.0, True, "cpu", TINY_CFG)
    assert _judge(r["program"], limits), r["program"]
    if "reference_bf16" in r:
        assert _judge(r["reference_bf16"], limits), r["reference_bf16"]
    assert not _judge(r["control"], limits), r["control"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in run.load_cell(CELLS[0])[0]["workloads"]])
def test_control_fails_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")
    _, _, spec, traffic, limits = run.load_cell(name)
    for seed in (2**33 + 11, 2**33 + 12, 2**33 + 13):
        r = readings(spec, traffic, seed, 2.0, True)
        assert _judge(r["program"], limits), (seed, r["program"])
        assert not _judge(r["control"], limits), (seed, r["control"])
        if r.get("fault") and "loss_gap" in r["fault"]:
            assert not _judge(r["fault"], limits), (seed, r["fault"])
