"""A cell of the benchmark at a size the CPU runs in seconds: the tiny
conv body, 256-wide heads, 48x64 images, tens of proposals and a 3-pass
TTA, with the cell's drivers, reference and checks unchanged.

The tiny size has limits of its own. Each lies between the program's
largest and the fp8 control's smallest reading (or a planted fault's)
over ten CPU seeds (2**33 + 0..9). Training, against the reference at
bf16, which on the CPU follows the program to rounding: program / control
/ fault grad_diff_mean 1.4e-4 / 7.1e-2 / 0.40, change_diff_mean 1.4e-4 /
5.6e-2 / 0.32, change_gap 1.7e-4 / (1, a state left unchanged), loss_gap
7.4e-8 / (fault 1.0e-2); evaluation, against float32: score_rms 2.4e-4 /
4.7e-4."""
from __future__ import annotations

import copy

from benchmark.run import load_cell

TINY_CFG = ["MODEL.CONV_BODY", "tiny.conv_body", "FAST_RCNN.MLP_HEAD_DIM", "256",
            "TEST.SCALE", "64", "TEST.BBOX_AUG.SCALES", "(48, 80)"]

TRAIN_STRATA = [
    {"scale": 64, "image_hw": [48, 64], "proposal_bucket": 32, "n_valid": [20, 32], "weight": 2},
    {"scale": 80, "image_hw": [64, 48], "proposal_bucket": 48, "n_valid": [33, 48], "weight": 1},
    {"scale": 64, "image_hw": [48, 64], "proposal_bucket": 48, "n_valid": [33, 48], "weight": 2},
]


TINY_LIMITS = {
    "train_step": {"loss_gap": {"limit": 1e-3}, "grad_diff_mean": {"limit": 5e-3},
                   "change_diff_mean": {"limit": 5e-3}, "change_gap": {"limit": 2e-2},
                   "grad_gap": {"limit": None}},
    "eval_tta": {"score_rms": {"limit": 3.6e-4}, "nms_mismatch": {"limit": 0}},
}


def tiny_traffic(traffic: dict) -> dict:
    """A copy of a traffic mix cut to the tiny size."""
    traffic = copy.deepcopy(traffic)
    if traffic["driver"] == "train_step":
        traffic.update(strata=copy.deepcopy(TRAIN_STRATA), trace_steps=2)
    else:
        traffic.update(image_shapes=[[48, 64], [64, 48]], windows=2, check_images=3,
                       strata=[{"n_valid": [20, 40], "counts": [3, 2]}])
    return traffic


def tiny_spec(spec: dict) -> dict:
    """A copy of a configuration file cut to the tiny size, on the tiny body."""
    spec = copy.deepcopy(spec)
    spec["model"].update(body="tiny", hidden=256, freeze_at=0)
    spec["test"].update(SCALE=64, AUG_SCALES=[48, 80])
    return spec


def tiny_cell(name: str):
    """(manifest, workload, configuration, traffic, limits) of the cell,
    cut to the tiny size, with the tiny size's limits."""
    bench, wl, spec, traffic, limits = load_cell(name)
    traffic = tiny_traffic(traffic)
    return (bench, wl, tiny_spec(spec), traffic,
            copy.deepcopy(TINY_LIMITS[traffic["driver"]]))
