"""Training-protocol benchmark on one CUDA card (port of bench.py's train
protocol).

    python -m cim_tpu_torch.tools.bench_train
    python -m cim_tpu_torch.tools.bench_train --device cpu --scales 480 \\
        --skip_4096 --n_valid 24 --set MODEL.CONV_BODY tiny.conv_body \\
        TPU.PRECISION f32                    # on the CPU, the tiny body

Prints ONE JSON line:
  {"metric": "train_images_per_sec_per_chip_protocol", "value": N,
   "unit": "images/sec/chip", "per_scale": {...}, ...}

Times the full resnet50_voc Trainer step (backbone forward and backward,
both RoIAlign kernels, the 3 CIM mining branches, the four losses, the SGD
update, GRAD_ACCUM 4) at EVERY TRAIN.SCALES bucket: the trainer draws a
random scale a step from (480, 576, 688, 864, 1200) (reference
lib/roi_data/minibatch.py:112), so the headline ``value`` is the
throughput of uniform sampling over the buckets, the harmonic mean of the
per-bucket rates. Then the reference's 4096-proposal cap at scale 1200,
with its peak device memory.

Synthetic data of production shape: --n_valid 2000 proposals (the typical
COB count of a VOC image) padded to the 2048 bucket; the image buckets are
what the loader's padding gives a 500x375 VOC image at each scale. Two
batches a bucket are staged on the card before the clock starts; each
bucket takes a warm step, then 10 timed steps at scales <= 576 and 6
above, each ending in the metrics' copy to the host. MFU is the analytic
model FLOPs (model_train_flops) over the H100's dense bf16 peak; it is
null on the CPU, where the times are not device times.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from cim_tpu_torch.config import cfg_from_list, clone_cfg, load_cfg
from cim_tpu_torch.data.loader import _bucket_hw, proposal_bucket
from cim_tpu_torch.data.synthetic import make_train_batch
from cim_tpu_torch.data.transforms import scale_for_target
from cim_tpu_torch.engine.train import Trainer
from cim_tpu_torch.tools.stability_run import to_device
from cim_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the reference's estimated throughput a device (it publishes none; bench.py's
# FLOP-derived estimate for its 2 V100/3090-class GPUs in float32)
REFERENCE_IMGS_PER_SEC_PER_DEVICE = 0.5

# the H100 SXM's dense bf16 peak (NVIDIA's data sheet; chip_smoke.PEAK_OPS_PER_S)
PEAK_FLOPS = 989e12

# the benchmark image: 500x375 landscape (the modal VOC shape)
IM_H, IM_W = 375, 500


def model_train_flops(n_props: int, feat_hw, dim_in: int = 1024,
                      hidden: int = 4096, num_classes: int = 20,
                      refine_times: int = 3, roi: int = 7) -> float:
    """Analytic FLOPs of one training image (fwd + bwd ~= 3x fwd matmul
    FLOPs). Head terms dominate; the backbone is counted coarsely."""
    r2 = roi * roi
    # MaskFuse: 3x3 conv (2C -> C) on N x 7 x 7 + two FCs
    conv = n_props * r2 * (2 * dim_in) * dim_in * 9 * 2
    fc1 = n_props * (dim_in * r2) * hidden * 2
    fc2 = n_props * hidden * hidden * 2
    heads = n_props * hidden * (num_classes + 1) * 2 * (2 + 2 * refine_times)
    # RoIAlign as the Kronecker matmul: (N*r2) x (H*W) x C
    h, w = feat_hw
    roi_align = n_props * r2 * h * w * dim_in * 2
    # resnet50 conv1..layer3: ~3.26 GMAC at 224^2, scaled by pixels
    backbone = 2 * 3.26e9 * (h * 16 * w * 16) / (224 * 224)
    fwd = conv + fc1 + fc2 + heads + roi_align + backbone
    return 3.0 * fwd


def bucket_for_scale(scale: int, max_size: int, multiple: int = 128):
    """The loader's image bucket for the benchmark image at ``scale``, and
    its true (h, w)."""
    s = scale_for_target((IM_H, IM_W), scale, max_size)
    true_hw = (int(round(IM_H * s)), int(round(IM_W * s)))
    return _bucket_hw(*true_hw, multiple), true_hw


def protocol_rate(images_per_sec) -> float:
    """Uniform scale sampling: the mean time an image is the mean of the
    buckets' times, so the protocol rate is the harmonic mean of theirs."""
    return float(1.0 / np.mean([1.0 / r for r in images_per_sec]))


def card_line(device) -> str | None:
    """nvidia-smi's name and power limit of ``device``'s card (None on the CPU)."""
    if device.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[device.index if device.index is not None else torch.cuda.current_device()]


def measure_bucket(trainer, cfg, scale, n_valid, n_pad, accum, rng, pad_multiple, log=print):
    """A warm step, then the timed steps at one (image scale, proposal pad)
    bucket; returns its per_scale record."""
    device = trainer.device
    bucket, true_hw = bucket_for_scale(scale, cfg.TRAIN.MAX_SIZE, pad_multiple)
    kw = dict(image_hw=bucket, n_props=n_pad, n_valid=n_valid,
              num_classes=cfg.MODEL.NUM_CLASSES)
    batches = [to_device({k: v[0] for k, v in make_train_batch(rng, 1, accum, **kw).items()},
                         device) for _ in range(2)]
    trainer.step(batches[0])  # warm-up: cuDNN's algorithm search, the allocator
    n_steps = 10 if scale <= 576 else 6
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for i in range(n_steps):
        trainer.step(batches[i % 2])  # each ends in the metrics' copy to the host
    dt = time.perf_counter() - t0

    imgs_per_sec = n_steps * accum / dt
    feat_pad = (bucket[0] // 16, bucket[1] // 16)
    feat_true = (true_hw[0] // 16, true_hw[1] // 16)
    mfu_model = mfu_padded = None
    if device.type == "cuda":
        mfu_model = imgs_per_sec * model_train_flops(n_valid, feat_true) / PEAK_FLOPS
        mfu_padded = imgs_per_sec * model_train_flops(n_pad, feat_pad) / PEAK_FLOPS
        if not mfu_model < 1.0:
            raise AssertionError(f"scale {scale}: implied MFU {mfu_model:.2f} > 1: a timing "
                                 "artifact (device work not awaited?)")
    rec = {
        "bucket_hw": list(bucket),
        "s_per_step": round(dt / n_steps, 4),
        "images_per_sec": round(imgs_per_sec, 3),
        "ms_per_image": round(1000.0 / imgs_per_sec, 1),
        "mfu_padded": None if mfu_padded is None else round(mfu_padded, 4),
        "mfu_model": None if mfu_model is None else round(mfu_model, 4),
    }
    log(f"# scale {scale} N {n_valid}->{n_pad}: {rec}")
    return rec


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", default=os.path.join(REPO, "configs", "resnet50_voc.yaml"))
    ap.add_argument("--n_valid", type=int, default=2000, help="proposals an image")
    ap.add_argument("--scales", default=None,
                    help="comma-separated scales (default: cfg.TRAIN.SCALES)")
    ap.add_argument("--skip_4096", action="store_true",
                    help="skip the 4000 -> 4096 proposal run at the largest scale")
    ap.add_argument("--pad_multiple", type=int, default=0,
                    help="image bucket multiple (default: cfg.TPU.PAD_MULTIPLE)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--set", dest="set_cfgs", nargs="+", default=None,
                    help="config key-value pairs, applied after the yaml")
    return ap.parse_args(argv)


def main(argv=None, log=print):
    """Run the protocol; returns the printed JSON's dict."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = clone_cfg(load_cfg(args.cfg))
    if args.set_cfgs:
        cfg_from_list(cfg, args.set_cfgs)
    cfg.TPU.DATA_PARALLEL = 1
    cfg.TPU.PALLAS_ROI_ALIGN = True  # the kernel's grid cap (4), as bench.py on a chip
    accum = cfg.TPU.GRAD_ACCUM  # 4, the reference's iter_size
    n_pad = proposal_bucket(cfg, args.n_valid)
    scales = ([int(s) for s in args.scales.split(",")] if args.scales
              else list(cfg.TRAIN.SCALES))
    pad_multiple = args.pad_multiple or int(cfg.TPU.PAD_MULTIPLE)
    cfg.TPU.PAD_MULTIPLE = pad_multiple
    rng = np.random.RandomState(0)
    trainer = Trainer(cfg, device=device, seed=0,
                      init_generator=torch.Generator(device=device).manual_seed(0))

    per_scale = {}
    for scale in scales:
        per_scale[scale] = measure_bucket(trainer, cfg, scale, args.n_valid, n_pad, accum, rng,
                                          pad_multiple, log)

    # the worst-case proposal bucket: the reference caps rois at 4096 an
    # image (lib/roi_data/minibatch.py:92-106); pinned at the largest
    # image bucket, not extrapolated
    bucket_4096 = None
    if not args.skip_4096:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        bucket_4096 = measure_bucket(trainer, cfg, scales[-1], 4000,
                                     proposal_bucket(cfg, 4000), accum, rng, pad_multiple, log)
        if device.type == "cuda":
            bucket_4096["peak_device_gb"] = round(torch.cuda.max_memory_allocated(device) / 1e9,
                                                  2)

    protocol_ips = protocol_rate([per_scale[s]["images_per_sec"] for s in scales])
    mfus = [per_scale[s]["mfu_model"] for s in scales]
    out = {
        "metric": "train_images_per_sec_per_chip_protocol",
        "value": round(protocol_ips, 3),
        "unit": "images/sec/chip",
        "vs_baseline": round(protocol_ips / REFERENCE_IMGS_PER_SEC_PER_DEVICE, 3),
        "vs_baseline_basis": {
            "anchor": "flop_estimate",
            "reference_imgs_per_sec_per_device": REFERENCE_IMGS_PER_SEC_PER_DEVICE,
        },
        "ok": True,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "card": card_line(device),
        "proposal_pad": n_pad,
        "ms_per_image": round(1000.0 / protocol_ips, 1),
        "mfu_model_protocol": None if None in mfus else round(float(np.mean(mfus)), 4),
        "images_per_sec_480_bucket": per_scale[scales[0]]["images_per_sec"],
        "per_scale": per_scale,
    }
    if bucket_4096 is not None:
        out["proposal_4096_at_1200"] = bucket_4096
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
