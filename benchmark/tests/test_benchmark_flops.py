"""The benchmark's FLOP, tap and byte counts against hand counts at small
shapes."""
from __future__ import annotations

import numpy as np
import pytest

from benchmark import flops


def test_head_flops_per_roi():
    c, h = 8, 16
    conv = 2 * (c * 49) * (2 * c * 9)  # 2 x outputs x (inputs x taps) of the 3x3 conv
    fcs = 2 * (c * 49) * h + 2 * h * h
    heads = 4 * 2 * h * 3  # classifier, detector, one refine pair; 2 classes + bg
    fwd = conv + fcs + heads
    assert flops.head_flops_per_roi(c, h, 2, 1, False) == fwd
    # backward: the input gradient and the weight gradient of every layer
    assert flops.head_flops_per_roi(c, h, 2, 1, True) == 3 * fwd


def test_body_flops_tiny(tmp_path, monkeypatch):
    monkeypatch.setattr(flops, "CACHE", str(tmp_path / "flops.json"))
    convs = [2 * 16 * 16 * 8 * 27, 2 * 8 * 8 * 16 * 72, 2 * 4 * 4 * 32 * 144, 2 * 2 * 2 * 32 * 288]
    assert flops._body_flops("tiny", 32, 32, False, 0) == sum(convs)
    # the image takes no gradient: the first conv computes its weight's only
    assert flops._body_flops("tiny", 32, 32, True, 0) == 2 * convs[0] + 3 * sum(convs[1:])
    # a cached count is read back
    assert flops.body_flops("tiny", 32, 32, False, 0) == sum(convs)
    assert "body tiny 32 32 0 0" in (tmp_path / "flops.json").read_text()


def test_frozen_stages_get_no_gradient():
    fwd = flops._body_flops("resnet50", 64, 64, False, 2)
    train = flops._body_flops("resnet50", 64, 64, True, 2)
    assert fwd < train < 3 * fwd


def test_roi_taps_and_least_time():
    rois = np.array([[0, 0, 31, 31], [0, 0, 159, 159]], np.float32)
    assert flops.roi_taps(rois, 1 / 16, 4) == 49 * 4 * 1 + 49 * 4 * 4
    assert flops.roi_taps(rois, 1 / 16, 1) == 2 * 49 * 4
    n_bytes = 2 * 3 * 8 * 2 + 10 * 16 + 10 * 49 * 8 * 2
    assert flops.roi_fwd_least([(2, 3)], 8, 10, 980) == pytest.approx(n_bytes / 3.35e12)
    n_bytes = 10 * 49 * 8 * 2 + 10 * 16 + 4 * 5 * 8 * 2
    assert flops.roi_bwd_least((4, 5), 8, 10, 980) == pytest.approx(n_bytes / 3.35e12)
    assert flops.least_seconds(1.0, 989e12) == pytest.approx(1.0)
