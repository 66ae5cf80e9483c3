"""Both drivers end to end on the CPU at the tiny size: a run of each cell
past the harness's look for a card, with the cell's limits; then the same
runs with the timed path broken underneath, once for each fault the cell
can have, each of which must come out not correct."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import TINY_CFG, tiny_cell

TRAIN, EVAL = "resnet50_voc.train_protocol", "vgg16_voc.eval_tta_b8"


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(name, trace=False, seconds=1.5, seed=2**33 + 5):
    bench, wl, spec, traffic, limits = tiny_cell(name)
    return run.run_cell(bench, wl, spec, traffic, limits, seed, seconds, trace, device="cpu",
                        extra_cfg=TINY_CFG, proc_start=time.time())


@pytest.mark.parametrize("name", [TRAIN, EVAL])
def test_a_run(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    e2e = {m["name"] for m in run.metrics_of(run.load_cell(name)[0], name, False)}
    assert set(res["metrics"]) == e2e
    assert all(c["limit"] is None or c["value"] <= c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("name", [TRAIN, EVAL])
def test_a_traced_run(name):
    res = _run(name, trace=True, seconds=2.5)
    assert res["correct"], res["checks"]
    # off the card no device metric is read, but the sub-window was traced
    assert res["metrics"] == {}
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    spans = {name for name, _ in res["breakdown"]["idle_gaps"]}
    assert spans & {"bench.step", "bench.eval_window", "cim.forward", "cim.backward",
                    "cim.mining", "cim.losses"}


def _sgd_unchanged(mp):
    from cim_tpu_torch.engine import optimizer

    mp.setattr(optimizer.SGD, "step", lambda self, lr: None)


def _half_batch(mp):
    from cim_tpu_torch.engine.train import Trainer

    orig = Trainer.microbatch
    mp.setattr(Trainer, "microbatch", lambda self, batch, i: orig(self, batch, i % 2))


def _half_passes(mp):
    from cim_tpu_torch.engine.test import Evaluator

    orig = Evaluator.tta_pass_list
    mp.setattr(Evaluator, "tta_pass_list",
               staticmethod(lambda cfg: orig(cfg)[: len(orig(cfg)) // 2]))


def _answer_altered(mp):
    from cim_tpu_torch.engine import test_engine

    orig = test_engine.box_results_with_nms_and_limit

    def altered(cfg, scores, boxes):
        s, b, cls_boxes = orig(cfg, scores, boxes)
        cls_boxes = list(cls_boxes)
        j = max(range(1, len(cls_boxes)), key=lambda k: len(cls_boxes[k]))
        cls_boxes[j] = cls_boxes[j][:-1]  # one detection dropped
        return s, b, cls_boxes

    mp.setattr(test_engine, "box_results_with_nms_and_limit", altered)


def _score_altered(mp):
    from cim_tpu_torch.engine.test import BatchedEvaluator

    orig = BatchedEvaluator.im_detect_all_many

    def altered(self, items, window=None):
        out = []
        for scores, boxes in orig(self, items, window):
            scores = scores.copy()  # each image's best score up by 5 % of its range
            scores[np.unravel_index(np.argmax(scores), scores.shape)] += 0.05 * np.ptp(scores)
            out.append((scores, boxes))
        return out

    mp.setattr(BatchedEvaluator, "im_detect_all_many", altered)


FAULTS = [(TRAIN, _sgd_unchanged), (TRAIN, _half_batch), (EVAL, _half_passes),
          (EVAL, _answer_altered), (EVAL, _score_altered)]


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f.__name__.strip("_") for _, f in FAULTS])
def test_a_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(name)
    assert not res["correct"], res["checks"]
