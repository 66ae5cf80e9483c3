"""The traffic generator: the same seed gives the same inputs, another seed
other inputs of the same shapes, and the draws follow the mix."""
from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch

from benchmark import generate
from benchmark.run import load_cell
from benchmark.tests.tiny import tiny_cell


@pytest.fixture(scope="module")
def train_mix():
    _, _, spec, traffic, _ = tiny_cell("resnet50_voc.train_protocol")
    return spec, traffic


@pytest.fixture(scope="module")
def eval_mix():
    return tiny_cell("resnet50_voc.eval_tta_b8")[3]


def _same(a, b):
    return all(torch.equal(torch.as_tensor(a["batch"][k]), torch.as_tensor(b["batch"][k]))
               for k in a["batch"])


def test_train_pool_is_the_seeds(train_mix):
    spec, traffic = train_mix
    big = 2**40 + 7  # seeds beyond 32 bits
    a = generate.train_pool(traffic, spec["model"], big, "cpu")
    b = generate.train_pool(traffic, spec["model"], big, "cpu")
    c = generate.train_pool(traffic, spec["model"], big + 1, "cpu")
    assert all(_same(x, y) for x, y in zip(a, b))
    assert not any(_same(x, y) for x, y in zip(a, c))
    assert [x["batch"]["image"].shape for x in a] == [x["batch"]["image"].shape for x in c]


def test_train_pool_follows_the_mix(train_mix):
    spec, traffic = train_mix
    pool = generate.train_pool(traffic, spec["model"], 5, "cpu")
    accum = spec["model"]["grad_accum"]
    labels = []
    for st, step in zip(traffic["strata"], pool):
        b = step["batch"]
        lo, hi = st["n_valid"]
        n = b["valid"].sum(1).numpy()
        assert b["valid"].shape == (accum, st["proposal_bucket"])
        assert ((n >= lo) & (n <= hi)).all()
        scale = st["scale"] / max(st["image_hw"])
        want = [round(v * scale) for v in st["image_hw"]]
        assert (b["image_hw"] == np.array(want)).all()
        assert b["image"].shape[1] % traffic["pad_multiple"] == 0
        assert b["iou_map"].dtype == torch.float16
        for j in range(accum):
            k = int(n[j])
            iou = b["iou_map"][j, :k, :k].float()
            assert torch.allclose(iou, iou.T) and torch.allclose(iou.diagonal(), torch.ones(k))
            assert not b["iou_map"][j, k:].any() and not b["rois"][j, k:].any()
            rois = b["rois"][j, :k]
            assert (rois[:, 2] > rois[:, 0]).all() and (rois[:, 3] > rois[:, 1]).all()
            assert (b["mat"][j, :, 0] > 0).any() and not b["mat"][j, k:].any()
        labels.append(b["labels"].numpy())
    labels = np.concatenate(labels)
    per_image = labels.sum(1)
    assert per_image.min() >= 1 and per_image.max() <= 3 + 1
    assert (labels.sum(0) > 0).all()  # every class present in the pool


def test_train_walk_keeps_the_weights(train_mix):
    spec, traffic = train_mix
    pool = generate.train_pool(traffic, spec["model"], 5, "cpu")
    cycle = sum(st["weight"] for st in traffic["strata"])
    walk = generate.train_walk(traffic, pool, 9)
    first = [next(walk) for _ in range(cycle)]
    assert Counter(first) == {i: st["weight"] for i, st in enumerate(traffic["strata"])}
    again = generate.train_walk(traffic, pool, 9)
    assert [next(again) for _ in range(cycle)] == first


def test_train_checked_reaches_every_scale():
    traffic = load_cell("resnet50_voc.train_protocol")[3]
    pool = [{"meta": {"scale": st["scale"], "proposal_bucket": st["proposal_bucket"]}}
            for st in traffic["strata"]]
    top = max(st["scale"] for st in traffic["strata"])
    seen = set()
    for seed in range(2**40, 2**40 + 40):
        checked = generate.train_checked(pool, seed, 3)
        assert checked == generate.train_checked(pool, seed, 3)
        metas = [pool[i]["meta"] for i in checked]
        # the largest scale at the largest bucket runs first, then two other scales
        assert (metas[0]["scale"], metas[0]["proposal_bucket"]) == (top, 2560)
        assert len({m["scale"] for m in metas}) == 3
        seen.update(checked)
    assert {pool[i]["meta"]["scale"] for i in seen} == {st["scale"] for st in traffic["strata"]}
    assert {pool[i]["meta"]["proposal_bucket"] for i in seen if pool[i]["meta"]["scale"] < top} \
        == {2048, 2560}


def test_masks_and_ious_agree():
    boxes = torch.tensor([[0., 0., 9., 9.], [0., 0., 9., 9.], [20., 20., 29., 39.]])
    iou, asy = generate.iou_matrices(boxes, (48, 64))
    assert iou[0, 1] == 1 and iou[0, 2] == 0 and asy[2, 2] == 1
    m7 = generate.masks_7x7(boxes)
    assert m7.shape == (3, 7, 7) and m7[:, 3, 3].all() and not m7[:, 0, 0].any()


def test_eval_pool_follows_the_mix(eval_mix):
    a = generate.eval_pool(eval_mix, 2**35, "cpu")
    b = generate.eval_pool(eval_mix, 2**35, "cpu")
    c = generate.eval_pool(eval_mix, 2**35 + 1, "cpu")
    assert len(a) == eval_mix["windows"]
    for wa, wb, wc in zip(a, b, c):
        assert all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
                   for x, y in zip(wa, wb))
        flat = [np.concatenate([x[1].ravel() for x in w]) for w in (wa, wc)]
        assert len(flat[0]) != len(flat[1]) or not np.array_equal(*flat)
        shapes = Counter(tuple(x[0].shape[:2]) for x in wa)
        want = Counter()
        for st in eval_mix["strata"]:
            for hw, count in zip(eval_mix["image_shapes"], st["counts"]):
                want[tuple(hw)] += count
        assert shapes == want
        for im, boxes, masks in wa:
            lo, hi = eval_mix["strata"][0]["n_valid"]
            assert im.dtype == np.uint8 and lo <= len(boxes) <= hi
            assert masks.shape == (len(boxes), 7, 7)
            assert (boxes[:, 2] <= im.shape[1] - 1).all() and (boxes[:, 3] <= im.shape[0] - 1).all()
