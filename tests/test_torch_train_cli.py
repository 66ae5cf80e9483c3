"""The port's training CLI (cim_tpu_torch.tools.train) on the CPU.

In-process runs of ``main(argv)`` with ``--device cpu`` and the tiny body:
- the rescaled SOLVER (BASE_LR, STEPS, MAX_ITER) and the snapshot period
  for --iter_size 1, 2 and 4 against the formula of cim_tpu's
  tools/train.py:119-130 and :256-258, written out here;
- on an on-disk synthetic set through TrainLoader: 4 steps in one run
  against 2 steps, then --load_ckpt --resume for 2 more (losses and
  parameters within rtol 1e-5: the same float32 steps on the same
  batches, which a resumed loader continues);
- the pipelined metrics the CLI logs against Trainer.step's floats on the
  same batches (equal: the same step, read one step later);
- a RuntimeError injected at step 3 leaves the checkpoint of step 2 and
  step 2's metrics in the log;
- --load_detectron of a pickle of the port's own state_dict restores it.
"""
import json
import logging
import os
import pickle

import numpy as np
import pytest
import torch

from cim_tpu_torch.data import catalog
from cim_tpu_torch.data.loader import TrainLoader
from cim_tpu_torch.data.roidb import combined_roidb_for_training
from cim_tpu_torch.data.synthetic import write_synthetic_train_dataset
from cim_tpu_torch.engine.train import Trainer
from cim_tpu_torch.tools import train as train_cli
from tests.torch_parity import CONFIG_DIR

YAML = os.path.join(CONFIG_DIR, "resnet50_voc.yaml")
TINY = ["MODEL.CONV_BODY", "tiny.conv_body", "TPU.PRECISION", "f32",
        "TPU.MAX_CLUSTERS", "4", "FAST_RCNN.MLP_HEAD_DIM", "64"]
TOL = dict(rtol=1e-5, atol=1e-7)


def _ckpt_steps(out_dir):
    return sorted(int(f[len("model_step"):-len(".pth")])
                  for f in os.listdir(os.path.join(out_dir, "ckpt")))


def _load_model(path):
    return torch.load(path, map_location="cpu", weights_only=True)["model"]


@pytest.mark.parametrize("iter_size", [1, 2, 4])
def test_rescaled_solver_and_snapshots(tmp_path, iter_size):
    out = tmp_path / "out"
    summary = train_cli.main([
        "--cfg", YAML, "--device", "cpu", "--synthetic", "--iter_size", str(iter_size),
        "--synth_image", "64", "64", "--synth_props", "32", "--synth_valid", "24",
        "--output_dir", str(out), "--set", *TINY, "SOLVER.MAX_ITER", "8",
        "SOLVER.STEPS", "[0, 6]", "TRAIN.SNAPSHOT_ITERS", "4"])
    with open(out / "config_and_args.pkl", "rb") as f:
        saved = pickle.load(f)
    solver = saved["cfg"]["SOLVER"]
    # cim_tpu tools/train.py:119-130 with one device and one image a step
    original, batch = 1, 1
    scale = original / (iter_size * batch)
    assert solver["BASE_LR"] == 0.0005 * batch / original
    assert solver["STEPS"] == [int(s * scale + 0.5) for s in (0, 6)]
    max_iter = int(8 * scale + 0.5)
    assert solver["MAX_ITER"] == max_iter and summary["step"] == max_iter
    assert saved["cfg"]["TPU"]["GRAD_ACCUM"] == iter_size
    period = max(1, int(4 / (1 * iter_size)))  # :256-258
    assert _ckpt_steps(out) == list(range(period, max_iter + 1, period))
    assert [s for s, _ in summary["metrics"]] == list(range(max_iter))


def test_refuses_multi_gpu(tmp_path, monkeypatch):
    """The refusals of multi-GPU training that remain: more ranks than
    visible cards on cuda (one rank a card), --multihost without
    torchrun's environment, and a torchrun WORLD_SIZE other than
    TPU.DATA_PARALLEL's. TPU.DATA_PARALLEL 0 means every visible card."""
    def world(device, data_parallel, *extra):
        args = train_cli.parse_args(["--cfg", YAML, "--device", device, "--synthetic", *extra,
                                     "--set", "TPU.DATA_PARALLEL", str(data_parallel)])
        return train_cli._configure(args)[1]

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="1 card"):
        world("cuda", 2)
    assert world("cuda", 0) == 1 and world("cpu", 0) == 1 and world("cpu", 2) == 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert world("cuda", 0) == 4 and world("cuda", 2) == 2
    with pytest.raises(RuntimeError, match="torchrun"):
        train_cli.main(["--cfg", YAML, "--device", "cpu", "--synthetic", "--output_dir",
                        str(tmp_path), "--multihost"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="WORLD_SIZE=2"):
        world("cpu", 1)
    assert world("cpu", 2) == 2 and world("cuda", 0, "--multihost") == 2


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """6 images on disk and the CLI's flags to train on them: iter_size 2,
    scales 96 and 128 drawn per step, a snapshot every 2 steps."""
    root = tmp_path_factory.mktemp("train_cli")
    paths = write_synthetic_train_dataset(str(root), 6, 20, np.random.RandomState(0))
    catalog.register_dataset("torch_train_cli", {
        catalog.IM_DIR: paths["image_dir"], catalog.ANN_FN: paths["ann"],
    })
    flags = ["--cfg", YAML, "--device", "cpu", "--iter_size", "2", "--disp_interval", "10",
             "--set", *TINY, "TPU.PROPOSAL_PAD", "32", "TRAIN.DATASETS", "('torch_train_cli',)",
             "TRAIN.PROPOSAL_FILES", f"('{paths['props']}',)",
             "TRAIN.REFINE_FILES", f"('{paths['label_assign']}',)",
             "iou_dir", paths["iou_dir"], "asy_iou_dir", paths["asy_iou_dir"],
             "TRAIN.SCALES", "(96, 128)", "TRAIN.SNAPSHOT_ITERS", "4",
             "DATA_LOADER.NUM_THREADS", "1", "DATA_DIR", str(root)]
    full = train_cli.main(flags + ["--max_iter", "4", "--output_dir", str(root / "full")])
    return root, flags, full


def test_resume_reproduces_the_uninterrupted_run(disk):
    root, flags, full = disk
    assert full["step"] == 4 and _ckpt_steps(root / "full") == [2, 4]
    resumed = train_cli.main(flags + [
        "--max_iter", "4", "--output_dir", str(root / "resumed"), "--resume",
        "--load_ckpt", str(root / "full" / "ckpt" / "model_step2.pth")])
    assert [s for s, _ in resumed["metrics"]] == [2, 3]
    for (step, got), (want_step, want) in zip(resumed["metrics"], full["metrics"][2:]):
        assert step == want_step
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, **TOL, err_msg=f"step {step} {key}")
    got = _load_model(root / "resumed" / "ckpt" / "model_step4.pth")
    want = _load_model(root / "full" / "ckpt" / "model_step4.pth")
    for name, w in want.items():
        torch.testing.assert_close(got[name], w, **TOL)


def test_logged_metrics_are_the_trainers_steps(disk):
    """The CLI reads each step's metrics one step late; they are the floats
    Trainer.step gives for the same batches from the same seed."""
    root, flags, full = disk
    cfg, _ = train_cli._configure(train_cli.parse_args(flags + ["--max_iter", "4"]))
    roidb, _, _ = combined_roidb_for_training(cfg)
    loader = TrainLoader(cfg, roidb, 2, seed=3, prefetch=cfg.DATA_LOADER.PREFETCH)
    trainer = Trainer(cfg, device="cpu", seed=3,
                      init_generator=torch.Generator().manual_seed(3))
    batches = iter(loader)
    try:
        want = [trainer.step(next(batches)) for _ in range(4)]
    finally:
        loader.close()
    assert [s for s, _ in full["metrics"]] == [0, 1, 2, 3]
    for (_, got), w in zip(full["metrics"], want):
        assert got == w


@pytest.mark.parametrize("num_workers", [1, 2])
def test_loader_start_continues_the_sequence(disk, num_workers):
    """TrainLoader(start=k) hands out the seed's batches from the k-th on
    (it passes over the first k): with images of
    more proposals than the pad (20 > 16), whose subsampling draws from the
    loader's generator when it builds in its own thread, and with a worker
    pool, whose builds draw from generators of their own."""
    _, flags, _ = disk
    flags = list(flags)
    flags[flags.index("TPU.PROPOSAL_PAD") + 1] = "16"
    cfg, _ = train_cli._configure(train_cli.parse_args(flags))
    roidb, _, _ = combined_roidb_for_training(cfg)
    assert all(len(e["boxes"]) > 16 for e in roidb)

    def take(start, n):
        loader = TrainLoader(cfg, roidb, 2, seed=3, num_workers=num_workers, start=start)
        batches = iter(loader)
        try:
            return [next(batches) for _ in range(n)]
        finally:
            loader.close()

    whole = take(0, 5)
    tail = take(3, 2)
    for got, want in zip(tail, whole[3:]):
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_crash_saves_the_last_completed_step(disk, tmp_path, monkeypatch, caplog):
    root, flags, full = disk
    step_async = Trainer.step_async

    def failing(self, batch):
        if self.step_count == 2:
            raise RuntimeError("injected at step 3")
        return step_async(self, batch)

    monkeypatch.setattr(Trainer, "step_async", failing)
    flags = list(flags)
    flags[flags.index("TRAIN.SNAPSHOT_ITERS") + 1] = "100"  # no snapshot before the crash
    with caplog.at_level(logging.INFO):
        summary = train_cli.main(flags + ["--max_iter", "4", "--output_dir", str(tmp_path)])
    assert summary["step"] == 2 and _ckpt_steps(tmp_path) == [2]
    got = _load_model(tmp_path / "ckpt" / "model_step2.pth")
    want = _load_model(root / "full" / "ckpt" / "model_step2.pth")
    for name, w in want.items():
        torch.testing.assert_close(got[name], w, **TOL)
    logged = [json.loads(r.getMessage()) for r in caplog.records
              if r.getMessage().startswith('{"iter"')]
    assert [rec["iter"] for rec in logged] == [0, 1]  # step 2's by the crash flush
    assert logged[-1]["loss"] == pytest.approx(
        np.median([m["total_loss"] for _, m in full["metrics"][:2]]), rel=1e-5)


def test_load_detectron_restores_the_state(tmp_path):
    cfg_flags = ["--cfg", YAML, "--device", "cpu", "--synthetic", "--synth_image", "64", "64",
                 "--synth_props", "32", "--synth_valid", "24", "--set", *TINY]
    cfg, _ = train_cli._configure(train_cli.parse_args(cfg_flags))
    state = Trainer(cfg, device="cpu", init_generator=torch.Generator().manual_seed(11)
                    ).model.state_dict()
    with open(tmp_path / "weights.pkl", "wb") as f:
        pickle.dump({"blobs": {"module." + k: v.numpy() for k, v in state.items()}}, f)
    train_cli.main(cfg_flags + ["--max_iter", "0", "--output_dir", str(tmp_path / "out"),
                                "--load_detectron", str(tmp_path / "weights.pkl")])
    got = _load_model(tmp_path / "out" / "ckpt" / "model_step0.pth")
    assert got.keys() == state.keys()
    for name, w in state.items():
        assert torch.equal(got[name], w), name
