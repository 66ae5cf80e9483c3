"""The port's training loader against cim_tpu's, on the CPU.

build_microbatch, proposal_bucket, load_iou_maps and TrainLoader of
cim_tpu_torch.data.loader must give the arrays of cim_tpu.data.loader bit
for bit for the same roidb and seed (the port's TrainLoader has one
device, so its batches are cim_tpu's with the device axis dropped).
Images come from a seeded stand-in for cv2.imread.
"""
import os

import numpy as np
import pytest

import cim_tpu.data.loader as jl
import cim_tpu_torch.data.loader as tl
from cim_tpu.config import load_cfg
from cim_tpu.data.synthetic import mask_matrices, masks_to_7x7, synthetic_masks
from cim_tpu_torch.config import load_cfg as torch_load_cfg

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "resnet50_voc.yaml")


def _entry(rng, i, h=96, w=128, n=30, num_classes=20):
    masks, boxes = synthetic_masks(rng, n, h, w)
    iou, asy = mask_matrices(masks)
    gt = np.zeros((1, num_classes), np.int32)
    gt[0, rng.choice(num_classes, 2, replace=False)] = 1
    mat = np.zeros((n, num_classes + 1), np.float32)
    mat[rng.choice(n, 5, replace=False), np.nonzero(gt[0])[0][0] + 1] = 1
    return {
        "id": i + 1, "image": f"/nonexistent/{i}.jpg", "height": h, "width": w,
        "flipped": False, "boxes": boxes.astype(np.float32),
        "masks": masks_to_7x7(masks, boxes).astype(np.float32), "gt_classes": gt,
        "gt_boxes": np.zeros((0, 5), np.float32), "mat": mat,
        "iou_map": iou, "asy_iou_map": asy,
    }


def _image(entry):
    r = np.random.RandomState(entry["id"])
    return (r.rand(entry["height"], entry["width"], 3) * 255).astype(np.uint8)


def _cfgs(pad=40):
    out = []
    for cfg in (load_cfg(CONFIG), torch_load_cfg(CONFIG)):
        cfg.TPU.PROPOSAL_PAD = pad
        out.append(cfg)
    return out


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("pad", [40, 16], ids=["padded", "subsampled"])
@pytest.mark.parametrize("scale", [0.5, 1.0])
def test_build_microbatch_matches_jax(pad, scale):
    jcfg, tcfg = _cfgs(pad)
    entry = _entry(np.random.RandomState(0), 0)
    bucket = jl._bucket_hw(int(96 * scale), int(128 * scale))
    assert tl._bucket_hw(int(96 * scale), int(128 * scale)) == bucket
    want = jl.build_microbatch(jcfg, entry, scale, bucket, np.random.RandomState(1),
                               image=_image(entry))
    got = tl.build_microbatch(tcfg, entry, scale, bucket, np.random.RandomState(1),
                              image=_image(entry))
    _assert_same(got, want)
    assert got["iou_map"].dtype == np.float16 and got["valid"].sum() == min(pad, 30)


def test_proposal_bucket_matches_jax():
    jcfg, tcfg = _cfgs(4096)
    for buckets in ((1024, 2048, 4096), ()):
        jcfg.TPU.PROPOSAL_BUCKETS = tcfg.TPU.PROPOSAL_BUCKETS = buckets
        for n in (30, 500, 1024, 1500, 2000, 3000, 4000, 9000):
            assert tl.proposal_bucket(tcfg, n) == jl.proposal_bucket(jcfg, n), (buckets, n)
    assert tl.proposal_bucket(tcfg, 2000) == 4096
    tcfg.TPU.PROPOSAL_BUCKETS = (1024, 1536, 2048, 2560, 3072, 4096)
    assert tl.proposal_bucket(tcfg, 2000) == 2048


def test_load_iou_maps_matches_jax():
    jcfg, tcfg = _cfgs()
    entry = _entry(np.random.RandomState(2), 0)
    for index in (np.arange(30), np.array([3, 1, 2, 7]), np.arange(5, 20)):
        for got, want in zip(tl.load_iou_maps(tcfg, entry, index),
                             jl.load_iou_maps(jcfg, entry, index)):
            assert got.dtype == want.dtype == np.float16
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_workers", [1, 2])
def test_train_loader_matches_jax(monkeypatch, num_workers):
    """Three steps of GRAD_ACCUM 2 from both loaders, over images with
    two proposal counts and two scales (so groups form by bucket)."""
    jcfg, tcfg = _cfgs(64)
    for cfg in (jcfg, tcfg):
        cfg.TRAIN.SCALES = (96, 128)
        cfg.TPU.PROPOSAL_BUCKETS = (32, 64)
    rng = np.random.RandomState(3)
    entries = [_entry(rng, i, n=(20 if i % 2 else 50)) for i in range(8)]
    for mod in (jl, tl):
        orig = mod.build_microbatch
        monkeypatch.setattr(mod, "build_microbatch",
                            lambda cfg, e, s, b, r, image=None, _orig=orig, **kw:
                            _orig(cfg, e, s, b, r, image=_image(e), **kw))
    jload = jl.TrainLoader(jcfg, entries, n_devices=1, grad_accum=2, seed=0,
                           num_workers=num_workers)
    tload = tl.TrainLoader(tcfg, entries, grad_accum=2, seed=0, num_workers=num_workers)
    try:
        jit, tit = iter(jload), iter(tload)
        for _ in range(3):
            want = {k: v[0] for k, v in next(jit).items()}
            got = next(tit)
            assert got["rois"].shape[0] == 2
            _assert_same(got, want)
    finally:
        jload.close()
        tload.close()
