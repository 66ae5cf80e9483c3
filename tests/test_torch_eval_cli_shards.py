"""The port's test_net CLI (cim_tpu_torch.tools.test_net) on the CPU:
its fan-out, waiting and gate, held against its own single-process run
(tests/test_torch_eval_cli.py holds that run against cim_tpu's).

The resnet50_voc config in float32 with a narrow head (the
tests/torch_parity.small_cfg settings, as --set flags), seeded PyTorch
weights saved with save_ckpt, 2 on-disk JPEGs, 2 TTA passes:
- --range shards merged with parallel.merge_sharded_results, and
  --multi_proc 2 (child processes), give the single-process detections.pkl
  and metrics exactly;
- the parent drops --multi_proc from the children's arguments and takes
  no abbreviation of it;
- --wait loads a checkpoint that another thread writes after a delay, and
  wait_for_checkpoint raises TimeoutError after timeout_s;
- a seeded EXPECTED_RESULTS mismatch exits non-zero (as
  tests/test_full_cli_chain.py checks for cim_tpu's CLI).
"""
import json
import os
import pickle
import shutil
import subprocess
import sys
import threading
import time
from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cim_tpu_torch.config import load_cfg
from cim_tpu_torch.data import catalog
from cim_tpu_torch.data.synthetic import write_synthetic_coco_dataset
from cim_tpu_torch.engine import checkpoint
from cim_tpu_torch.models.builder import build_model
from cim_tpu_torch.parallel import merge_sharded_results
from cim_tpu_torch.tools import test_net as test_net_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "configs", "resnet50_voc.yaml")
STEP = 3
N_IMAGES = 2
DATASET = "torch_eval_cli_shards"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The on-disk set (also in a registry file for the children), a
    checkpoint of seeded weights and the CLI's flags."""
    tmp = tmp_path_factory.mktemp("torch_eval_cli_shards")
    _, props = write_synthetic_coco_dataset(str(tmp), N_IMAGES, 30, np.random.RandomState(7),
                                            image_hw=(72, 96), write_jpegs=True)
    spec = {"image_directory": str(tmp), "annotation_file": str(tmp / "ann.json")}
    catalog.register_dataset(DATASET, spec)
    registry = tmp / "registry.json"
    registry.write_text(json.dumps({DATASET: spec}))
    env = pytest.MonkeyPatch()
    env.setenv("CIM_TPU_DATASET_REGISTRY", str(registry))

    sets = ["TPU.PRECISION", "f32", "TPU.PALLAS_ROI_ALIGN", "False",
            "TPU.REMAT_BOX_HEAD", "False", "FAST_RCNN.MLP_HEAD_DIM", "256",
            "TEST.DATASETS", f"('{DATASET}',)", "TEST.PROPOSAL_FILES", f"('{props}',)",
            "TEST.SCALE", "96", "TEST.BBOX_AUG.SCALES", "()", "TPU.EVAL_BATCH", "1",
            "DATA_DIR", str(tmp)]
    model = build_model(load_cfg(YAML, sets), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    ckpt_dir = str(tmp / "ckpt")
    checkpoint.save_ckpt(ckpt_dir, SimpleNamespace(
        model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.1),
        step_count=STEP, seed=0))
    flags = ["--cfg", YAML, "--device", "cpu", "--load_ckpt", ckpt_dir, "--set", *sets]
    yield SimpleNamespace(tmp=tmp, flags=flags, ckpt_dir=ckpt_dir, runs={})
    env.undo()


def _run(setup, name, extra):
    """The CLI's summary of a run named ``name`` (each runs once)."""
    if name not in setup.runs:
        setup.runs[name] = test_net_cli.main(
            setup.flags + list(extra) + ["--output_dir", str(setup.tmp / name)])
    return setup.runs[name]


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_range_shards_merge_to_the_single_process_run(setup):
    single = _load(_run(setup, "single", [])["det_file"])
    parts = []
    for s, e in ((0, 1), (1, N_IMAGES)):
        run = _run(setup, f"range{s}", ["--range", str(s), str(e)])
        assert run["results"] is None
        assert run["det_file"].endswith(f"detections_range_{s}_{e}.pkl")
        parts.append(_load(run["det_file"]))
    merged = merge_sharded_results(parts)
    assert sorted(merged) == sorted(single)
    for name, rec in single.items():
        assert set(merged[name]) == {"scores", "boxes"}
        np.testing.assert_array_equal(merged[name]["scores"], rec["scores"])
        np.testing.assert_array_equal(merged[name]["boxes"], rec["boxes"])


def test_multi_proc_children_give_the_single_process_run(setup):
    single_run = _run(setup, "single", [])
    single = _load(single_run["det_file"])
    got = _run(setup, "multi", ["--multi_proc", "2"])
    assert got["model"] is None  # parent mode builds no model
    merged = _load(got["det_file"])
    assert sorted(merged) == sorted(single)
    for name, rec in single.items():
        np.testing.assert_array_equal(merged[name]["scores"], rec["scores"])
        np.testing.assert_array_equal(merged[name]["boxes"], rec["boxes"])
    out = setup.tmp / "multi"
    assert sorted(p for p in os.listdir(out) if "_range_" in p) == [
        "detections_range_0_1.pkl", f"detections_range_1_{N_IMAGES}.pkl"]
    for key, value in single_run["results"].items():
        np.testing.assert_array_equal(got["results"][key], value)


def test_child_argv_drops_multi_proc():
    argv = ["--cfg", "x.yaml", "--multi_proc", "2", "--multi_proc=3", "--set", "A", "1"]
    assert test_net_cli._child_argv(argv, "/out", True) == [
        "--cfg", "x.yaml", "--set", "A", "1", "--output_dir", "/out"]
    with pytest.raises(SystemExit):  # no abbreviations: --multi would reach the children
        test_net_cli.parse_args(["--cfg", "x.yaml", "--multi", "2"])


def test_wait_loads_a_checkpoint_written_later(setup, monkeypatch):
    later = setup.tmp / "later_ckpt"
    later.mkdir()
    src = os.path.join(setup.ckpt_dir, f"model_step{STEP}.pth")

    def write():
        time.sleep(0.5)
        shutil.copy(src, later / "part.tmp")
        os.replace(later / "part.tmp", later / f"model_step{STEP}.pth")

    writer = threading.Thread(target=write)
    monkeypatch.setattr(test_net_cli, "wait_for_checkpoint",
                        partial(checkpoint.wait_for_checkpoint, poll_s=0.05, timeout_s=120))
    writer.start()
    try:
        flags = [f if f != setup.ckpt_dir else str(later) for f in setup.flags]
        got = test_net_cli.main(flags + ["--wait", "--range", "0", "1",
                                         "--output_dir", str(setup.tmp / "waited")])
    finally:
        writer.join(timeout=60)
    assert not writer.is_alive()
    assert got["step"] == STEP


def test_wait_for_checkpoint_times_out(tmp_path):
    with pytest.raises(TimeoutError):
        checkpoint.wait_for_checkpoint(str(tmp_path), poll_s=0.01, timeout_s=0.05)
    assert checkpoint.checkpoint_location(str(tmp_path / "model_step12.pth")) == (str(tmp_path), 12)
    assert checkpoint.checkpoint_location(str(tmp_path)) == (str(tmp_path), None)


def test_expected_results_mismatch_exits_nonzero(setup):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "cim_tpu_torch.tools.test_net", *setup.flags,
         "EXPECTED_RESULTS", f"[['{DATASET}','box','AP',99.0]]", "EXPECTED_RESULTS_ATOL",
         "0.001", "EXPECTED_RESULTS_RTOL", "0.0", "--output_dir", str(setup.tmp / "gate")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0
    assert "FAIL" in proc.stdout + proc.stderr
