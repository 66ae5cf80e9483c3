"""The port's segmented long-horizon runner
(cim_tpu_torch/tools/long_horizon_run.py) against cim_tpu's
tools/long_horizon_run.py, on the CPU.

The decay prescale and the result summary are the root tool's functions,
loaded from its file and called on the same inputs: they must be equal.
The LR schedule the segments log must equal cim_tpu's at every step
across a warm-up and a decay. Then the port's runner goes end to end,
with tests/test_long_horizon_cpu.py's flags (24 steps in two fresh-process
segments of the tiny body, decay at 16, warm-up 4), and the run must hold
what that test holds cim_tpu's run to, plus each segment's closing
run_end line.
"""
import argparse
import importlib.util
import json
import os

import numpy as np
import pytest

from cim_tpu.config import load_cfg as jax_load_cfg
from cim_tpu.engine.optimizer import lr_schedule as jax_lr_schedule
from cim_tpu_torch.config import load_cfg
from cim_tpu_torch.engine.optimizer import lr_schedule
from cim_tpu_torch.tools import long_horizon_run
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs", "resnet50_voc.yaml")


def _root_tool():
    spec = importlib.util.spec_from_file_location(
        "root_long_horizon_run", os.path.join(REPO, "tools", "long_horizon_run.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("devices", [1, 2])
@pytest.mark.parametrize("iter_size", [1, 4])
def test_prescale_decay_matches_root_tool(devices, iter_size):
    args = argparse.Namespace(cfg=CFG, decay_at=3000, iter_size=iter_size, devices=devices)
    got = long_horizon_run._prescale_decay(args)
    assert got == _root_tool()._prescale_decay(args)
    assert got == 3000 * iter_size * devices  # NUM_GPUS 1


def _trajectory(rng):
    rows = []
    for it in list(range(0, 24, 4)) + [23]:
        row = {"iter": it, "time": 0.1, "lr": float(np.float32(5e-4 if it < 16 else 5e-5)),
               "loss": round(3.2 - 0.01 * it + rng.rand() * 1e-3, 6)}
        for k in range(3):
            row[f"mined_gt_{k}"] = float(rng.randint(1, 5))
            row[f"fg_frac_{k}"] = round(rng.rand(), 6)
            row[f"has_gt_{k}"] = 1.0
        rows.append(row)
    return rows


@pytest.mark.parametrize("partial", [False, True])
def test_summarize_matches_root_tool(partial):
    args = argparse.Namespace(total_steps=24, segment_steps=12, decay_at=16, warmup=4, disp=4)
    traj = _trajectory(np.random.RandomState(0))
    bounds = [{"segment": 0, "first_iter": 0, "first_loss": traj[0]["loss"], "last_iter": 8,
               "last_loss": traj[2]["loss"]}]
    segs = [{"segment": 0, "max_iter": 12, "wall_s": 1.0, "stats_lines": 3}]
    got = long_horizon_run._summarize(args, 2, traj, bounds, segs, partial)
    want = _root_tool()._summarize(args, 2, traj, bounds, segs, partial)
    assert got == want
    assert got["lr_decay_ratio"] == 0.1 and got["partial"] is partial


def test_lr_schedule_matches_cim_tpu_across_warmup_and_decay():
    jcfg, tcfg = jax_load_cfg(CFG), load_cfg(CFG)
    for c in (jcfg, tcfg):
        c.SOLVER.STEPS = [0, 16]
        c.SOLVER.WARM_UP_ITERS = 4
    for step in range(41):
        want = float(jax_lr_schedule(jcfg, step))
        np.testing.assert_allclose(lr_schedule(tcfg, step), want, rtol=1e-7, err_msg=step)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("long_horizon")
    out = tmp / "run.json"
    env = {"OMP_NUM_THREADS": "1"}  # each segment's torch on one thread
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        result = long_horizon_run.main([
            "--device", "cpu", "--total_steps", "24", "--segment_steps", "12",
            "--decay_at", "16", "--warmup", "4", "--disp", "4",
            "--synth_image", "64", "64", "--synth_props", "32", "--synth_valid", "24",
            "--workdir", str(tmp / "seg"), "--out", str(out),
            "--set", "MODEL.CONV_BODY", "tiny.conv_body", "FAST_RCNN.MLP_HEAD_DIM", "256",
        ])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return result, json.loads(out.read_text())


def test_run_writes_its_result(run):
    result, written = run
    assert written == result
    assert result["ok"] is True and result["partial"] is False
    assert result["segments"] == 2 and result["steps_completed"] == 24


def test_segments_stitch_without_gap_or_repeat(run):
    res = run[0]
    iters = [s["iter"] for s in res["trajectory_every_disp"]]
    assert iters == sorted(set(iters))
    seg_bounds = res["segment_boundaries"]
    assert seg_bounds[0]["first_iter"] == 0
    assert seg_bounds[1]["first_iter"] == 12
    assert seg_bounds[0]["last_iter"] < 12 <= seg_bounds[1]["first_iter"]


def test_decay_crossed_mid_run_after_warmup(run):
    res = run[0]
    assert res["lr_pre_decay"] is not None and res["lr_post_decay"] is not None
    assert abs(res["lr_decay_ratio"] - 0.1) < 1e-6
    assert res["trajectory_every_disp"][0]["lr"] < res["lr_pre_decay"]


def test_losses_finite_and_mining_health_surfaced(run):
    res = run[0]
    assert res["first_loss"] is not None and res["final_loss"] is not None
    assert np.isfinite([s["loss"] for s in res["trajectory_every_disp"]]).all()
    mh = res["mining_health"]
    assert mh["fg_frac_end"] is not None and mh["has_gt_end"] is not None


def test_each_segment_reports_its_run_end(run):
    segs = run[0]["segments_wall"]
    assert [s["max_iter"] for s in segs] == [12, 24]
    for s in segs:
        assert s["device"] == "cpu" and s["peak_device_gb"] is None  # no card: no device peak
        assert 0.05 < s["peak_rss_gb"] < 50
        # on the CPU the wrappers run the plain versions, not the kernels
        assert s["roi_align_fwd_launches"] == s["roi_align_bwd_launches"] == 0
        assert s["nms_launches"] == 0


def test_a_short_segment_fails_the_run(tmp_path, monkeypatch):
    """A segment whose CLI stopped before its last step (it saves a crash
    and returns 0) fails the run as a non-zero exit does, and the partial
    artifact says which."""
    def short(args, seg, workdir, max_iter):
        return 0, [], {"step": max_iter - 1}, 0.1, "crashed"

    monkeypatch.setattr(long_horizon_run, "run_segment", short)
    out = tmp_path / "r.json"
    with pytest.raises(RuntimeError, match="segment 0 failed"):
        long_horizon_run.main(["--device", "cpu", "--total_steps", "4", "--segment_steps", "2",
                               "--workdir", str(tmp_path), "--out", str(out)])
    failed = json.loads(out.read_text())
    assert failed["ok"] is False and failed["failed_segment"] == 0


def _fake_segment(fail_at=None):
    """run_segment's stand-in: two stats lines a segment and its run_end."""
    def run(args, seg, workdir, max_iter):
        if seg == fail_at:
            return 1, [], None, 0.1, "boom"
        first = max_iter - args.segment_steps
        stats = [{"iter": it, "lr": 1e-3, "loss": 3.0 - 0.01 * it} for it in (first, max_iter - 1)]
        end = {"step": max_iter, "device": "cpu", "max_memory_allocated": None,
               "ru_maxrss_kb": 1024, "roi_align_fwd_launches": 0, "roi_align_bwd_launches": 0,
               "nms_launches": 0}
        return 0, stats, end, 0.1, ""
    return run


def test_resume_from_a_partial_artifact(tmp_path, monkeypatch):
    """--resume_from continues an interrupted run at its next segment and
    keeps the trajectory captured before the interruption."""
    out = tmp_path / "r.json"
    argv = ["--device", "cpu", "--total_steps", "6", "--segment_steps", "2", "--disp", "1",
            "--workdir", str(tmp_path), "--out", str(out)]
    monkeypatch.setattr(long_horizon_run, "run_segment", _fake_segment(fail_at=2))
    with pytest.raises(RuntimeError, match="segment 2 failed"):
        long_horizon_run.main(argv)
    partial = json.loads(out.read_text())
    assert partial["partial"] and len(partial["segments_wall"]) == 2
    seen = []

    def resumed(args, seg, workdir, max_iter):
        seen.append(seg)
        return _fake_segment()(args, seg, workdir, max_iter)

    monkeypatch.setattr(long_horizon_run, "run_segment", resumed)
    res = long_horizon_run.main(argv + ["--resume_from", str(out)])
    assert seen == [2] and res["ok"] and not res["partial"]
    assert [s["iter"] for s in res["trajectory_every_disp"]] == [0, 1, 2, 3, 4, 5]
    assert [b["first_iter"] for b in res["segment_boundaries"]] == [0, 2, 4]
