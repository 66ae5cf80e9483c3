"""Per-image N x N mask-IoU and asymmetric-IoU matrices of COB proposals
(port of tools/pre/create_cob_iou.py; reference tools/pre/create_cob_iou.py
and create_cob_asy_iou.py).

    python -m cim_tpu_torch.tools.pre.create_cob_iou --ann_file data/voc/trainaug.json \\
        --cob_dir data/VOC2012/COB --iou_dir data/cob_iou --asy_iou_dir data/cob_asy_iou
    python -m cim_tpu_torch.tools.pre.create_cob_iou --device cpu ...   # on the CPU

For each image of the annotation file, in id order: its .mat masks go to
--device, where both matrices come from one float32 product
(ops.mask_iou.mask_iou_matrices), and are stored as float16 pkls named
after the .mat (2012_000001.pkl), the files the trainer reads from
cfg.iou_dir / cfg.asy_iou_dir. The .mat load on the host takes most of
an image's time; main() returns each image's split.
"""
from __future__ import annotations

import argparse
import os
import pickle
import time

import torch

from cim_tpu_torch.ops.mask_iou import mask_iou_matrices
from cim_tpu_torch.tools.pre.generate_7_7 import image_ids, load_cob_mat, mat_path_for
from cim_tpu_torch.utils.device import resolve_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="COB IoU matrices")
    parser.add_argument("--ann_file", required=True)
    parser.add_argument("--cob_dir", required=True)
    parser.add_argument("--iou_dir", required=True)
    parser.add_argument("--asy_iou_dir", required=True)
    parser.add_argument("--dataset", choices=["voc", "coco"], default="voc")
    parser.add_argument("--pad_to", type=int, default=128,
                        help="accepted for cim_tpu's command lines; no effect here (it "
                        "bounds XLA's compiles there), the output is the same")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    """Returns {n_images, image_s, load_s, product_ms, peak_bytes}: each
    image's seconds in all and in its .mat load (host clock), the time of
    its product and float16 rounding on the device (CUDA events on a card,
    the host clock on the CPU) and the device's peak memory (0 on the CPU)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    os.makedirs(args.iou_dir, exist_ok=True)
    os.makedirs(args.asy_iou_dir, exist_ok=True)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    ids = image_ids(args.ann_file)
    image_s, load_s, product_ms = [], [], []
    for k, img_id in enumerate(ids):
        path = mat_path_for(args.cob_dir, img_id, args.dataset)
        t0 = time.perf_counter()
        masks = torch.from_numpy(load_cob_mat(path))
        load_s.append(time.perf_counter() - t0)
        with torch.no_grad():
            masks = masks.to(device)
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t1 = time.perf_counter()
            iou, asy = (m.half() for m in mask_iou_matrices(masks))
            if on_card:
                end.record()
            iou, asy = iou.cpu().numpy(), asy.cpu().numpy()
            product_ms.append(start.elapsed_time(end) if on_card
                              else 1e3 * (time.perf_counter() - t1))
        del masks
        base = os.path.splitext(os.path.basename(path))[0] + ".pkl"
        for d, m in ((args.iou_dir, iou), (args.asy_iou_dir, asy)):
            with open(os.path.join(d, base), "wb") as f:
                pickle.dump(m, f, pickle.HIGHEST_PROTOCOL)
        image_s.append(time.perf_counter() - t0)
        if k % 100 == 0:
            print(f"{k + 1}/{len(ids)}", flush=True)
    print("done")
    return {"n_images": len(ids), "image_s": image_s, "load_s": load_s,
            "product_ms": product_ms,
            "peak_bytes": torch.cuda.max_memory_allocated(device) if on_card else 0}


if __name__ == "__main__":
    main()
