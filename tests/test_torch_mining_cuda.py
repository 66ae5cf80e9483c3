"""On the card: the greedy-NMS kernel and mining's CUDA graphs against the
eager path, bit for bit.

- ops/nms.greedy_nms_from_iou (csrc/nms_from_iou.cu) against
  greedy_nms_rounds, the plain loop, on the same CUDA tensors: random,
  quantized (ties at the threshold) and asymmetric IoU matrices, scores
  with ties, invalid entries and all-invalid rows, K from 1 to 410, 20 and
  80 classes;
- engine.train.mine_pseudo_labels through the Trainer's MiningGraphs
  against the same call op by op, on every output of PseudoLabels: both
  proposal buckets of the benchmark (2048, 2560), keys seen again
  (replays), the class budget, and MIST through mining.cim.mine_branches;
  outputs of an earlier replay stay as they were after later ones;
- a warm mining call makes no host sync.

Run on a card with

    python -m pytest tests/test_torch_mining_cuda.py -m cuda

(it skips without a CUDA device). The file imports no JAX.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from cim_tpu_torch.config import load_cfg
from cim_tpu_torch.engine.train import mine_pseudo_labels, mining_params_for_branch
from cim_tpu_torch.mining import cim
from cim_tpu_torch.ops.nms import greedy_nms_from_iou, greedy_nms_rounds

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _nms_case(rng, classes, k, kind):
    iou = rng.rand(classes, k, k).astype(np.float32)
    if kind != "asymmetric":
        iou = (iou + iou.transpose(0, 2, 1)) / 2
    if kind == "quantized":  # many entries exactly at mining's thresholds
        iou = np.round(iou * 20) / 20
    scores = rng.rand(classes, k).astype(np.float32)
    if kind != "float":
        scores = np.round(scores * 4) / 4
    valid = rng.rand(classes, k) > 0.3
    valid[::7] = False  # all-invalid rows
    return iou, scores, valid


@pytest.mark.cuda
@pytest.mark.parametrize("classes", [20, 80])
@pytest.mark.parametrize("k", [1, 2, 31, 32, 33, 64, 205, 256, 410])
@pytest.mark.parametrize("kind", ["float", "quantized", "asymmetric"])
def test_nms_kernel_matches_the_plain_loop(card, classes, k, kind):
    rng = np.random.RandomState(k * 7 + classes)
    iou, scores, valid = (torch.from_numpy(x).to(card)
                          for x in _nms_case(rng, classes, k, kind))
    for thresh in (0.25, 0.35, 0.45000000000000007, 0.5):
        launches = greedy_nms_from_iou.kernel_launches
        got = greedy_nms_from_iou(iou, scores, thresh, valid=valid)
        assert greedy_nms_from_iou.kernel_launches == launches + 1
        want = greedy_nms_rounds(iou, scores, thresh, valid=valid)
        assert got.dtype == torch.bool and torch.equal(got, want), (thresh, kind)
        assert not (got & ~valid).any()
    # without a validity mask, and with leading axes
    got = greedy_nms_from_iou(iou.view(2, classes // 2, k, k), scores.view(2, -1, k), 0.35)
    assert torch.equal(got.view(classes, k), greedy_nms_rounds(iou, scores, 0.35))


def _cfg(budget=0):
    cfg = load_cfg(os.path.join(ROOT, "configs", "resnet50_voc.yaml"))
    cfg.TPU.MINING_CLASS_BUDGET = budget
    return cfg


def _microbatch(card, n, n_valid, seed, c=20, n_labels=2, refine=3):
    """Head outputs and a batch of one image at proposal bucket n: boxes'
    IoU and containment as float16 maps, softmax class and detector
    scores, n_labels image labels (0: nothing to mine)."""
    g = torch.Generator(device=card).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=card)

    xy = rand(n, 2) * torch.tensor([400.0, 300.0], device=card)
    wh = 8 + rand(n, 2) * torch.tensor([300.0, 250.0], device=card)
    boxes = torch.cat([xy, xy + wh], 1)
    lt = torch.maximum(boxes[:, None, :2], boxes[None, :, :2])
    rb = torch.minimum(boxes[:, None, 2:], boxes[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area = wh.prod(-1)
    iou = inter / (area[:, None] + area[None, :] - inter)
    asy = inter / area[None, :]  # asy[i, j]: the share of j inside i
    valid = torch.arange(n, device=card) < n_valid
    labels = torch.zeros(c, device=card)
    labels[torch.randperm(c, generator=g, device=card)[:n_labels]] = 1
    mask = valid[:, None]

    def heads():
        logits = 4 * rand(n, c + 1)
        cls = torch.softmax(logits, -1)
        det = torch.softmax((4 * rand(n, c + 1)).masked_fill(~mask, -1e30), 0)
        return cls * mask, det

    (p_cls, p_det), *refine_pairs = [heads() for _ in range(refine)]
    out = {"predict_cls": p_cls, "predict_det": p_det,
           "refine_cls": torch.stack([a for a, _ in refine_pairs]),
           "refine_iou": torch.stack([torch.sigmoid(b) for _, b in refine_pairs])}
    batch = {"labels": labels, "iou_map": (iou * mask * mask.T).half(),
             "asy_iou_map": (asy * mask * mask.T).half(), "valid": valid}
    return out, batch


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name, a, b in zip(w._fields, g, w):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert torch.equal(a, b), name


# (bucket, valid rows, seed, labels): the benchmark's two buckets, each
# seen again, one image with nothing to mine
_STREAM = [(2048, 1800, 2**33 + 1, 2), (2560, 2400, 2**33 + 2, 3), (2048, 1537, 2**33 + 3, 1),
           (2560, 2049, 2**33 + 4, 0), (2048, 2048, 2**33 + 5, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [0, 4])
def test_graph_replayed_mining_matches_eager(card, budget):
    cfg = _cfg(budget)
    graphs = cim.MiningGraphs()
    gen = torch.Generator(device=card)
    launches = greedy_nms_from_iou.kernel_launches
    kept = []
    for n, n_valid, seed, n_labels in _STREAM:
        out, batch = _microbatch(card, n, n_valid, seed, n_labels=n_labels)
        want = mine_pseudo_labels(cfg, out, batch, gen, seed=seed)
        got = mine_pseudo_labels(cfg, out, batch, gen, seed=seed, graphs=graphs)
        _assert_same(got, want)
        kept.append((got, want, n_labels))
    torch.cuda.synchronize()
    # later replays in the shared pool left earlier outputs as they were
    for got, want, n_labels in kept:
        _assert_same(got, want)
        assert bool(got[0].has_gt) == (n_labels > 0)
    assert len(graphs) == 2
    assert (graphs.captures, graphs.replays, graphs.eager_runs) == (2, 3, 2)
    pool, static = graphs.device_bytes()
    assert (pool is None or pool > 0) and static > 0
    # one NMS launch a branch and call, eager or replayed; none at capture
    assert greedy_nms_from_iou.kernel_launches - launches == 2 * len(_STREAM) * cfg.REFINE_TIMES


@pytest.mark.cuda
def test_graph_replayed_mist_matches_eager(card):
    cfg = _cfg()
    params = [mining_params_for_branch(cfg, k) for k in range(cfg.REFINE_TIMES)]
    graphs = cim.MiningGraphs()
    gen = torch.Generator(device=card)
    for n, n_valid, seed, n_labels in _STREAM:
        out, batch = _microbatch(card, n, n_valid, seed, n_labels=n_labels)
        sources = [(out["predict_cls"], out["predict_det"])] + [
            (out["refine_cls"][k], out["refine_iou"][k]) for k in range(cfg.REFINE_TIMES - 1)]
        gen.manual_seed(seed)
        uniforms = [cim.draw_uniforms(c, d, batch["labels"], p, gen, using_cim=False)
                    for (c, d), p in zip(sources, params)]
        args = (sources, batch["labels"], batch["iou_map"], batch["asy_iou_map"],
                batch["valid"], params, uniforms)
        want = cim.mine_branches(*args, using_cim=False)
        got = cim.mine_branches(*args, using_cim=False, graphs=graphs)
        _assert_same(got, want)
        assert bool(got[0].has_gt) == (n_labels > 0)
    assert len(graphs) == 2


@pytest.mark.cuda
def test_warm_mining_makes_no_host_sync(card):
    cfg = _cfg()
    graphs = cim.MiningGraphs()
    gen = torch.Generator(device=card)
    out, batch = _microbatch(card, 2560, 2300, 2**33 + 7)
    mine_pseudo_labels(cfg, out, batch, gen, seed=1, graphs=graphs)  # warm-up and capture
    out, batch = _microbatch(card, 2560, 2100, 2**33 + 8)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        replayed = mine_pseudo_labels(cfg, out, batch, gen, seed=2, graphs=graphs)
        eager = mine_pseudo_labels(cfg, out, batch, gen, seed=2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _assert_same(replayed, eager)
