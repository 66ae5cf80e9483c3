"""The port's training CLI at world size 2 on the CPU: ``main(argv)`` with
``--device cpu --set TPU.DATA_PARALLEL 2`` spawns two gloo ranks, each
training on its strided shard of an on-disk synthetic set (tiny body,
float32, anti-noise sampling on, iter_size 2, a snapshot every 3 steps).

- Rank 0 alone writes the config pickle and the snapshots; the LR and the
  steps are rescaled for 2 ranks (cim_tpu tools/train.py:118-130).
- The logged step-0 metrics are the mean over the ranks of each rank's
  loss on its own first batch, computed here at world size 1 with the
  rank's anti-noise seeds (rtol 1e-5: float32 sums in another order).
- A run resumed from the step-3 snapshot reproduces steps 4-6 (metrics
  and final parameters within rtol 1e-5, test_torch_train_cli.py's bound).
- The world-2 snapshot holds the bare model's keys, loads into a world-1
  Trainer, and into test_net.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from cim_tpu_torch import parallel
from cim_tpu_torch.data import catalog
from cim_tpu_torch.data.loader import TrainLoader
from cim_tpu_torch.data.roidb import combined_roidb_for_training
from cim_tpu_torch.data.synthetic import write_synthetic_train_dataset
from cim_tpu_torch.engine.checkpoint import load_ckpt
from cim_tpu_torch.engine.train import Trainer, derive_seed
from cim_tpu_torch.tools import test_net
from cim_tpu_torch.tools import train as train_cli
from tests.torch_parity import CONFIG_DIR

YAML = os.path.join(CONFIG_DIR, "resnet50_voc.yaml")
TINY = ["MODEL.CONV_BODY", "tiny.conv_body", "TPU.PRECISION", "f32",
        "TPU.MAX_CLUSTERS", "4", "FAST_RCNN.MLP_HEAD_DIM", "64"]
TOL = dict(rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """8 images on disk; a 6-step world-2 run and one resumed from its
    step-3 snapshot."""
    root = tmp_path_factory.mktemp("ddp_cli")
    paths = write_synthetic_train_dataset(str(root), 8, 20, np.random.RandomState(1))
    catalog.register_dataset("torch_ddp_cli", {
        catalog.IM_DIR: paths["image_dir"], catalog.ANN_FN: paths["ann"],
    })
    data = ["TPU.PROPOSAL_PAD", "32", "TRAIN.DATASETS", "('torch_ddp_cli',)",
            "TRAIN.PROPOSAL_FILES", f"('{paths['props']}',)",
            "TRAIN.REFINE_FILES", f"('{paths['label_assign']}',)",
            "iou_dir", paths["iou_dir"], "asy_iou_dir", paths["asy_iou_dir"],
            "TRAIN.SCALES", "(96, 128)", "DATA_LOADER.NUM_THREADS", "1", "DATA_DIR", str(root)]
    flags = ["--cfg", YAML, "--device", "cpu", "--iter_size", "2", "--disp_interval", "1",
             "--set", *TINY, *data, "TRAIN.SNAPSHOT_ITERS", "12", "TPU.DATA_PARALLEL", "2"]
    full = train_cli.main(flags + ["--max_iter", "6", "--output_dir", str(root / "full")])
    resumed = train_cli.main(flags + [
        "--max_iter", "6", "--output_dir", str(root / "resumed"), "--resume",
        "--load_ckpt", str(root / "full" / "ckpt" / "model_step3.pth")])
    return root, paths, flags, data, full, resumed


def test_rank0_alone_writes(world2):
    root, _, _, _, full, _ = world2
    assert [r["step"] for r in full["ranks"]] == [6, 6]
    ckpt = root / "full" / "ckpt"
    assert full["ranks"][0]["written"] == [
        str(root / "full" / "config_and_args.pkl"), str(ckpt / "model_step3.pth"),
        str(ckpt / "model_step6.pth")]
    assert full["ranks"][1]["written"] == []
    assert sorted(os.listdir(ckpt)) == ["model_step3.pth", "model_step6.pth"]
    with open(root / "full" / "config_and_args.pkl", "rb") as f:
        cfg = pickle.load(f)["cfg"]
    # 2 ranks of one image: LR x 2, steps / 4 (2 ranks x iter_size 2)
    assert cfg["TPU"]["DATA_PARALLEL"] == 2 and cfg["SOLVER"]["BASE_LR"] == 0.0005 * 2
    # both ranks log the same reduced metrics
    assert full["ranks"][0]["metrics"] == full["ranks"][1]["metrics"]


def test_logged_metrics_are_the_mean_over_ranks(world2):
    _, _, flags, _, full, _ = world2
    cfg, world = train_cli._configure(train_cli.parse_args(flags))
    assert world == 2 and cfg.Anti_noise_sampling
    roidb, _, _ = combined_roidb_for_training(cfg)
    trainer = Trainer(cfg, device="cpu", seed=3,
                      init_generator=torch.Generator().manual_seed(3))
    per_rank = []
    for r in range(world):
        loader = TrainLoader(cfg, parallel.host_shard_roidb(roidb, r, world), 2, seed=3,
                             prefetch=cfg.DATA_LOADER.PREFETCH)
        try:
            batch = next(iter(loader))
        finally:
            loader.close()
        for i in range(2):
            _, losses = trainer.loss_fn(trainer.microbatch(batch, i), trainer.generator,
                                        derive_seed(3, 0, i, r))
            per_rank.append({k: v.item() for k, v in losses.items()})
    step, got = full["metrics"][0]
    assert step == 0
    for key in per_rank[0]:
        np.testing.assert_allclose(got[key], np.mean([m[key] for m in per_rank]), **TOL,
                                   err_msg=key)


def test_resume_reproduces_steps_4_to_6(world2):
    root, _, _, _, full, resumed = world2
    assert [s for s, _ in resumed["metrics"]] == [3, 4, 5]
    for (step, got), (want_step, want) in zip(resumed["metrics"], full["metrics"][3:]):
        assert step == want_step
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, **TOL, err_msg=f"step {step} {key}")
    got = torch.load(root / "resumed" / "ckpt" / "model_step6.pth", weights_only=True)["model"]
    want = torch.load(root / "full" / "ckpt" / "model_step6.pth", weights_only=True)["model"]
    for name, w in want.items():
        torch.testing.assert_close(got[name], w, **TOL)


def test_world2_snapshot_loads_at_world1_and_in_test_net(world2, tmp_path):
    root, paths, flags, data, _, _ = world2
    snapshot = root / "full" / "ckpt" / "model_step6.pth"
    state = torch.load(snapshot, weights_only=True)["model"]
    assert not any(k.startswith("module.") for k in state)
    cfg, _ = train_cli._configure(train_cli.parse_args(flags))
    single = Trainer(cfg, device="cpu")
    load_ckpt(str(snapshot.parent), single, 6)
    assert single.step_count == 6 and single.ddp is None
    for name, value in single.model.state_dict().items():
        assert torch.equal(value, state[name]), name
    det = test_net.main(["--cfg", YAML, "--device", "cpu", "--load_ckpt", str(snapshot),
                         "--range", "0", "2", "--output_dir", str(tmp_path), "--set", *TINY,
                         *data, "TEST.DATASETS", "('torch_ddp_cli',)",
                         "TEST.PROPOSAL_FILES", f"('{paths['props']}',)"])
    assert det["step"] == 6 and os.path.exists(det["det_file"])
    for name, value in det["model"].state_dict().items():
        assert torch.equal(value, state[name]), name
    assert len(det["all_scores"]) == 2
    assert all(np.isfinite(r["scores"]).all() for r in det["all_scores"].values())
