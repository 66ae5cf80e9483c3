"""The port's training-protocol benchmark (cim_tpu_torch/tools/bench_train.py)
against the root bench.py, on the CPU.

The image bucket of every TRAIN.SCALES scale and the analytic FLOPs at
N 2048 and 4096 must equal bench.py's (loaded from its file); the
protocol rate is the harmonic mean of the buckets' rates. Then main() at
one scale with the tiny body: its JSON has bench.py's keys (the
vs_baseline basis without bench.py's CPU anchor), and, on the CPU, no
MFU.
"""
import importlib.util
import os

import numpy as np
import pytest

from cim_tpu_torch.tools import bench_train
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALES = (480, 576, 688, 864, 1200)


def _bench():
    spec = importlib.util.spec_from_file_location("root_bench", os.path.join(REPO, "bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("multiple", [64, 128])
@pytest.mark.parametrize("scale", SCALES)
def test_bucket_for_scale_matches_bench(scale, multiple):
    assert bench_train.bucket_for_scale(scale, 2000, multiple) == \
        _bench().bucket_for_scale(scale, 2000, multiple)


def test_train_buckets_of_the_protocol():
    """The loader's buckets at the shipped PAD_MULTIPLE 64, and their
    stride-16 maps: the RoIAlign kernels' train shapes."""
    buckets = [bench_train.bucket_for_scale(s, 2000, 64)[0] for s in SCALES]
    assert buckets == [(384, 512), (448, 576), (576, 704), (704, 896), (960, 1216)]
    assert [(h // 16, w // 16) for h, w in buckets] == \
        [(24, 32), (28, 36), (36, 44), (44, 56), (60, 76)]


@pytest.mark.parametrize("n_props", [2000, 2048, 4000, 4096])
@pytest.mark.parametrize("scale", SCALES)
def test_model_train_flops_matches_bench(scale, n_props):
    bench = _bench()
    (h, w), _ = bench.bucket_for_scale(scale, 2000, 64)
    feat = (h // 16, w // 16)
    assert bench_train.model_train_flops(n_props, feat) == bench.model_train_flops(n_props, feat)


def test_protocol_rate_is_the_harmonic_mean():
    rates = [16.0, 15.0, 14.5, 14.0, 12.0]
    assert bench_train.protocol_rate(rates) == pytest.approx(5 / sum(1 / r for r in rates),
                                                             rel=1e-12)
    assert bench_train.protocol_rate([10.0, 10.0]) == pytest.approx(10.0)
    # one slow bucket weighs as its time does, not as its rate does
    assert bench_train.protocol_rate([1.0, 100.0]) < np.mean([1.0, 100.0]) / 25


def test_main_on_the_cpu_has_bench_keys():
    out = bench_train.main(["--device", "cpu", "--scales", "480", "--skip_4096",
                            "--n_valid", "24", "--set", "MODEL.CONV_BODY", "tiny.conv_body",
                            "TPU.PRECISION", "f32", "FAST_RCNN.MLP_HEAD_DIM", "256",
                            "TPU.PROPOSAL_PAD", "32"], log=lambda s: None)
    bench_keys = {"metric", "value", "unit", "vs_baseline", "vs_baseline_basis", "ok",
                  "proposal_pad", "ms_per_image", "mfu_model_protocol",
                  "images_per_sec_480_bucket", "per_scale"}
    assert bench_keys <= set(out)
    assert out["metric"] == "train_images_per_sec_per_chip_protocol"
    assert out["vs_baseline_basis"] == {"anchor": "flop_estimate",
                                        "reference_imgs_per_sec_per_device": 0.5}
    assert out["device"] == "cpu" and out["card"] is None and out["proposal_pad"] == 32
    rec = out["per_scale"][480]
    assert set(rec) >= {"bucket_hw", "images_per_sec", "ms_per_image", "mfu_padded",
                        "mfu_model"}
    assert rec["bucket_hw"] == [384, 512] and rec["images_per_sec"] > 0
    assert rec["mfu_model"] is None and out["mfu_model_protocol"] is None
    assert out["value"] == pytest.approx(rec["images_per_sec"], rel=1e-3)
    assert "proposal_4096_at_1200" not in out
