"""The port's step profiler and eval benchmarks
(cim_tpu_torch/tools/profile_step.py, bench_eval.py, bench_host_eval.py)
on the CPU at the smallest size.

Where cim_tpu's tool reports results beside its times, the port's must
equal them on the same seed: bench_host_eval's kept detections and RLEs an
image, and bench_eval e2e's box AP and instance-seg mAP50 (one TTA pass
over 2 synthetic images of 6 proposals, so that random weights detect the
gt proposals; the port runs cim_tpu's flax init through
state_dict_from_jax). cim_tpu's tools are loaded from their files.
profile_step and the other bench_eval modes report times only: each part
and mode runs and gives finite, positive numbers; no MFU without a card.
"""
import argparse
import importlib.util
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import cim_tpu.models.tiny  # noqa: F401  (registers tiny.conv_body)
from cim_tpu.config import clone_cfg, load_cfg as jax_load_cfg
from cim_tpu.models.builder import build_model as build_jax_model
from cim_tpu_torch.config import load_cfg
from cim_tpu_torch.tools import bench_eval, bench_host_eval, profile_step
from tests.torch_parity import init_variables, torch_model
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["MODEL.CONV_BODY", "tiny.conv_body", "TPU.PRECISION", "f32",
        "FAST_RCNN.MLP_HEAD_DIM", "256"]
HOST_ARGS = ["--images", "12", "--n_props", "400", "--coco_images", "6"]


def test_profile_step_parts_on_the_cpu():
    ms = profile_step.main(["--device", "cpu", "--image_hw", "64", "64", "--n_valid", "24",
                            "--iters", "2", "--set", *TINY, "TPU.PROPOSAL_PAD", "32"],
                           log=lambda s: None)
    assert list(ms) == ["forward (model only)", "mining x3 (cim_layer)",
                        "loss_fn (fwd+mine+losses)", "grad(loss_fn)", "full step / image"]
    assert all(np.isfinite(v) and v > 0 for v in ms.values())


def test_bench_eval_modes_on_the_cpu():
    lines = []
    records = bench_eval.main(["--device", "cpu", "--n_images", "2", "--n_props", "32",
                               "--eval_batch", "2", "--modes", "seq,batched,e2e", "--set",
                               *TINY, "TEST.BBOX_AUG.ENABLED", "False"], log=lines.append)
    assert [json.loads(s) for s in lines] == [records[m] for m in ("e2e", "seq", "batched")]
    for mode, metric in (("seq", "tta_eval_s_per_image_sequential"),
                         ("batched", "tta_eval_s_per_image_batched")):
        rec = records[mode]
        assert rec["metric"] == metric and rec["value"] > 0 and rec["passes"] == 1
        assert rec["device"] == "cpu" and rec["mfu_model"] is None
    e2e = records["e2e"]
    assert e2e["metric"] == "eval_pipeline_images_per_sec_e2e" and e2e["value"] > 0
    assert e2e["images"] == 2 and e2e["eval_batch"] == 2 and e2e["passes"] == 1
    assert 0.0 <= e2e["box_AP"] <= 1.0 and 0.0 <= e2e["inst_seg_mAP50"] <= 1.0
    assert e2e["seg_results"] > 0


def _root_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _e2e_cfg(cfg):
    cfg.MODEL.CONV_BODY = "tiny.conv_body"
    cfg.FAST_RCNN.MLP_HEAD_DIM = 256
    cfg.TPU.PRECISION = "f32"
    cfg.TPU.PALLAS_ROI_ALIGN = False  # the CPU runs no kernel: XLA's grid cap on both
    cfg.TPU.REMAT_BOX_HEAD = False
    cfg.TEST.BBOX_AUG.ENABLED = False
    return cfg


def test_bench_eval_e2e_metrics_match_cim_tpu(capsys, tmp_path):
    config = os.path.join(REPO, "configs", "resnet50_voc.yaml")
    jcfg = _e2e_cfg(clone_cfg(jax_load_cfg(config)))
    tcfg = _e2e_cfg(load_cfg(config))
    # the gt roidb cache is keyed by the dataset's name alone: no run of
    # another test or session may hand cim_tpu's tool its image paths
    jcfg.DATA_DIR = str(tmp_path)
    variables = init_variables(jcfg)
    args = argparse.Namespace(n_images=2, n_props=6, eval_batch=2)
    _root_tool("bench_eval").run_e2e(
        jcfg, types.SimpleNamespace(model=build_jax_model(jcfg)), variables, args)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = bench_eval.run_e2e(tcfg, torch_model(tcfg, variables), args, torch.device("cpu"),
                             log=lambda s: None)
    assert want["box_AP"] > 0 and want["inst_seg_mAP50"] > 0
    for key in ("box_AP", "inst_seg_mAP50"):
        assert got[key] == pytest.approx(want[key], abs=1e-12), key
    for key in ("metric", "images", "passes", "eval_batch"):
        assert got[key] == want[key], key


@pytest.fixture(scope="module")
def host_records():
    return bench_host_eval.main(HOST_ARGS, log=lambda s: None), _root_tool("bench_host_eval")


def test_bench_host_eval_counts_match_cim_tpu(host_records, monkeypatch, capsys):
    got, root = host_records
    monkeypatch.setattr(sys, "argv", ["bench_host_eval.py", *HOST_ARGS])
    root.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    for key in ("images", "n_props", "kept_dets_mean", "rles_mean"):
        assert got[key] == want[key], key
    assert got["kept_dets_mean"] > 0 and got["rles_mean"] > 0


def test_bench_host_eval_stage_times(host_records):
    got = host_records[0]
    stages = [got["det_nms_ms"], got["inst_seg_ms"], got["coco_eval_ms"]]
    assert all(t > 0 for t in stages)
    assert got["value"] == pytest.approx(sum(stages), abs=0.02)
