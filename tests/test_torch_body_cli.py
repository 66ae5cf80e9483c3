"""The port's training and test_net CLIs with the shipped VGG-16 config on
the CPU (a narrow MLP of 64, float32): two synthetic training steps with a
snapshot after each, then test_net from the last snapshot over an on-disk
set of two images (one partial stack at the config's EVAL_BATCH 8, so the
body takes one valid extent per image). The frozen convs (VGG.FREEZE_AT 2:
conv1 and conv2) are the same in both snapshots, every other parameter of
the body moved, and the detections are scores in [0, 1].
"""
import os
import pickle

import numpy as np
import torch

from cim_tpu_torch.data import catalog
from cim_tpu_torch.data.synthetic import write_synthetic_coco_dataset
from cim_tpu_torch.tools import test_net, train
from tests.torch_parity import CONFIG_DIR

YAML = os.path.join(CONFIG_DIR, "vgg16_voc.yaml")
NARROW = ["FAST_RCNN.MLP_HEAD_DIM", "64", "TPU.PRECISION", "f32", "TPU.MAX_CLUSTERS", "4"]


def _snapshot(out, step):
    path = os.path.join(out, "ckpt", f"model_step{step}.pth")
    return torch.load(path, map_location="cpu", weights_only=True)["model"]


def test_vgg16_train_then_test_net(tmp_path):
    out = str(tmp_path / "train")
    run = train.main(["--cfg", YAML, "--device", "cpu", "--synthetic", "--iter_size", "1",
                      "--synth_image", "64", "64", "--synth_props", "32", "--synth_valid", "24",
                      "--max_iter", "2", "--output_dir", out,
                      "--set", *NARROW, "TRAIN.SNAPSHOT_ITERS", "1"])
    assert run["step"] == 2 and len(run["metrics"]) == 2
    assert all(np.isfinite(list(m.values())).all() for _, m in run["metrics"])
    first, last = _snapshot(out, 1), _snapshot(out, 2)
    body = [k for k in first if k.startswith("Conv_Body.")]
    assert len(body) == 26  # 13 convs, weight and bias
    for k in body:
        frozen = k.startswith(("Conv_Body.conv1.", "Conv_Body.conv2."))
        assert torch.equal(first[k], last[k]) == frozen, k

    data = str(tmp_path / "data")
    os.makedirs(data)
    _, props = write_synthetic_coco_dataset(data, 2, 30, np.random.RandomState(4),
                                            image_hw=(72, 96), write_jpegs=True)
    catalog.register_dataset("torch_body_cli", {catalog.IM_DIR: data,
                                                catalog.ANN_FN: os.path.join(data, "ann.json")})
    det = test_net.main(["--cfg", YAML, "--device", "cpu", "--load_ckpt",
                         os.path.join(out, "ckpt"), "--output_dir", str(tmp_path / "test"),
                         "--set", *NARROW, "TEST.DATASETS", "('torch_body_cli',)",
                         "TEST.PROPOSAL_FILES", f"('{props}',)", "TEST.SCALE", "96",
                         "TEST.BBOX_AUG.SCALES", "()", "DATA_DIR", data])
    assert det["step"] == 2
    state = det["model"].state_dict()
    assert all(torch.equal(state[k], v) for k, v in last.items())
    with open(det["det_file"], "rb") as f:
        records = pickle.load(f)
    assert len(records) == 2
    for rec in records.values():
        s = rec["scores"]
        assert s.shape == (30, 20) and np.isfinite(s).all() and 0 <= s.min() <= s.max() <= 1
    kept = [d for per_class in det["all_boxes"][1:] for d in per_class if len(d)]
    assert kept and all(0 <= d[:, 4].min() <= d[:, 4].max() <= 1 for d in kept)
    assert np.isfinite(det["results"]["AP"])
