"""AGPL label assignment: PRM peaks -> proposal cluster matrix (port of
tools/pre/AGPL_label_assign.py; reference tools/pre/AGPL_label_assign.py:107-277).

    python -m cim_tpu_torch.tools.pre.AGPL_label_assign --ann_file data/voc/trainaug.json \\
        --img_dir data/VOC2012/JPEGImages --cob_dir data/VOC2012/COB \\
        --prm_ckpt prm.pth --output data/label_assign/voc_2012_label_assign.pkl
    python -m cim_tpu_torch.tools.pre.AGPL_label_assign --device cpu ...   # on the CPU

For each image of the annotation file, in id order:
  1. the PRM (FC-ResNet50 at 448x448, CRMs upsampled x8) on the image's
     ground-truth classes gives peaks and their response maps;
  2. for each peak, in ascending score order: the proposals whose mask
     covers the peak vote a "super-mask" (pixels in more than 0.7 of
     them), and the proposals of mask-IoU > 0.5 with it form a new cluster
     of the peak's class (a later peak overrides an earlier one);
  3. proposals overlapping some super-mask (0 < IoU <= 0.5) but in no
     cluster form the trailing background cluster.
Writes {indexes, mat}, the TRAIN.REFINE_FILES input. --prm_ckpt is a
reference-named PRM checkpoint, loaded straight into the port's model;
without one the model is a seeded random init (for pipeline tests). The
PRM runs in float32 with TF32 off (PeakResponseMapper's default).

Steps 2-3 run on --device for all peaks of an image at once, in exact
integer arithmetic: cim_tpu's f64 test mean > 0.7 and f32 test
inter / union > 0.5 are, below 2^23 pixels, 10 * votes > 7 * count and
2 * inter > union.
"""
from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np
import torch

from cim_tpu_torch.evaluation.coco import COCO
from cim_tpu_torch.models.layers import torch_default_init_
from cim_tpu_torch.prm.datasets import prm_transform
from cim_tpu_torch.prm.model import PeakResponseMapper, load_prm_checkpoint
from cim_tpu_torch.tools.pre.generate_7_7 import load_cob_mat, mat_path_for
from cim_tpu_torch.utils.device import resolve_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="AGPL label assignment")
    parser.add_argument("--ann_file", required=True)
    parser.add_argument("--img_dir", required=True)
    parser.add_argument("--cob_dir", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--prm_ckpt", default=None,
                        help="reference-named PRM checkpoint (fc_resnet50); a seeded "
                        "random init if absent (for pipeline testing)")
    parser.add_argument("--num_classes", type=int, default=20)
    parser.add_argument("--dataset", choices=["voc", "coco"], default="voc")
    parser.add_argument("--peak_threshold", type=float, default=10.0)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return parser.parse_args(argv)


def assign_cluster_sites(mask_proposals, sites, num_classes, device="cuda"):
    """The assignment core shared by the AGPL and point paths (reference
    AGPL_label_assign.py:145-185, point_level_label_assign.py:66-95).

    mask_proposals: (N, mh, mw) 0/1 masks; sites: (py, px, class_idx) in
    mask pixels, in application order (AGPL: ascending peak score; points:
    file order). Site s (from 0) makes cluster s + 1 of its class: the
    proposals of IoU > 0.5 with its super-mask, a later site overriding.
    A site that no proposal covers assigns nothing but still takes its
    cluster index. Proposals near some super-mask (0 < IoU <= 0.5) and in
    no cluster take the background cluster len(sites) + 1 in column 0; with
    no sites, every proposal takes cluster 1 there. Returns the (N,
    num_classes + 1) float32 matrix on the host; computed on ``device``."""
    device = resolve_device(device)
    masks = torch.as_tensor(np.asarray(mask_proposals)).to(device) != 0
    n, mh, mw = masks.shape
    sites = [(int(py), int(px), int(c)) for py, px, c in sites]
    la = torch.zeros((n, num_classes + 1), dtype=torch.float32, device=device)
    if not sites:
        la[:, 0] = 1
        return la.cpu().numpy()
    for py, px, _ in sites:  # numpy's indexing rule: negative wraps, beyond raises
        if not (-mh <= py < mh and -mw <= px < mw):
            raise IndexError(f"site ({py}, {px}) outside the {mh}x{mw} masks")
    py, px, cls = (torch.tensor(v, device=device) for v in zip(*sites))
    flat = masks.reshape(n, -1).to(torch.float32)
    covering = masks[:, py % mh, px % mw].T.to(torch.float32)  # (S, N)
    # exact counts: float32 products of 0/1 values, sums below 2^24
    votes = (covering @ flat).to(torch.int64)  # (S, P): covering masks on each pixel
    count = covering.sum(1).to(torch.int64)
    supermask = 10 * votes > 7 * count[:, None]  # mean > 0.7
    inter = (flat @ supermask.T.to(torch.float32)).to(torch.int64)  # (N, S)
    union = flat.sum(1).to(torch.int64)[:, None] + supermask.sum(1)[None, :] - inter
    assign = 2 * inter > union  # IoU > 0.5
    near = (2 * inter <= union) & (inter > 0)  # 0 < IoU <= 0.5
    # the last site that assigns a proposal sets its cluster and class
    cluster = (assign * torch.arange(1, len(sites) + 1, device=device)).max(1).values
    assigned = cluster > 0
    col = torch.where(assigned, cls[(cluster - 1).clamp(min=0)] + 1, torch.zeros_like(cluster))
    bg = near.any(1) & ~assigned
    val = torch.where(assigned, cluster, bg * (len(sites) + 1))
    la.scatter_(1, col[:, None], val[:, None].to(torch.float32))
    return la.cpu().numpy()


def assign_image(mask_proposals, peaks, peak_scores, num_peaks, num_classes, crm_size=112,
                 device="cuda"):
    """Steps 2-3 for one image (reference :145-185). peaks: (K, 3) [y, x,
    cls] in the upsampled CRM (112 = 14 * 8), applied in ascending score
    order (numpy's argsort, as cim_tpu), mapped to mask pixels on the host."""
    mh, mw = np.shape(mask_proposals)[1:]
    order = np.argsort(np.asarray(peak_scores)[:num_peaks])
    sites = []
    for j in order:
        y, x, class_idx = peaks[j]
        sites.append((min(int(y * mh / crm_size), mh - 1),
                      min(int(x * mw / crm_size), mw - 1), class_idx))
    return assign_cluster_sites(mask_proposals, sites, num_classes, device)


def load_prm_image(path, size=448):
    """An image as the PRM reads it (prm_transform: RGB, bilinear resize to
    size x size, [0, 1], ImageNet mean/std); (size, size, 3) float32."""
    from PIL import Image

    return prm_transform(np.asarray(Image.open(path).convert("RGB")), size=size)


def build_mapper(args, device):
    """The PRM of --prm_ckpt, or of a seeded random init."""
    mapper = PeakResponseMapper(num_classes=args.num_classes, sub_pixel_locating_factor=8,
                                peak_threshold=args.peak_threshold, device=device)
    if args.prm_ckpt:
        load_prm_checkpoint(mapper.model, args.prm_ckpt)
    else:
        torch_default_init_(mapper.model, torch.Generator(device=device).manual_seed(0))
    return mapper


def main(argv=None):
    """Returns {output, n_images, load_s, prm_s, assign_s, num_peaks,
    peaks, peak_scores}: per image the seconds of its image and .mat load,
    of the PRM (host clock, ending in the maps' copy back) and of the
    assignment, its peak count, and its valid peaks and scores."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    coco_gt = COCO(args.ann_file)
    img_ids = sorted(coco_gt.getImgIds())
    cat_to_contig = {c: i for i, c in enumerate(sorted(coco_gt.getCatIds()))}
    mapper = build_mapper(args, device)

    out = {"indexes": [], "mat": []}
    summary = {k: [] for k in ("load_s", "prm_s", "assign_s", "num_peaks", "peaks",
                               "peak_scores")}
    for k, img_id in enumerate(img_ids):
        t0 = time.perf_counter()
        arr = load_prm_image(os.path.join(args.img_dir, coco_gt.imgs[img_id].get("file_name", "")))
        gt_classes = sorted({cat_to_contig[a["category_id"]] for a in coco_gt.img_to_anns[img_id]})
        masks = load_cob_mat(mat_path_for(args.cob_dir, img_id, args.dataset))
        t1 = time.perf_counter()
        peaks = mapper.inference_gt(arr, gt_classes)
        t2 = time.perf_counter()
        la = assign_image(masks, peaks.peaks, peaks.peak_scores, peaks.num_peaks,
                          args.num_classes, device=device)
        t3 = time.perf_counter()
        out["indexes"].append(img_id)
        out["mat"].append(la)
        for key, v in (("load_s", t1 - t0), ("prm_s", t2 - t1), ("assign_s", t3 - t2),
                       ("num_peaks", peaks.num_peaks),
                       ("peaks", peaks.peaks[:peaks.num_peaks]),
                       ("peak_scores", peaks.peak_scores[:peaks.num_peaks])):
            summary[key].append(v)
        if k % 50 == 0:
            print(f"{k + 1}/{len(img_ids)}", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with open(args.output, "wb") as f:
        pickle.dump(out, f, pickle.HIGHEST_PROTOCOL)
    print(f"wrote {len(out['indexes'])} mats -> {args.output}")
    return {"output": args.output, "n_images": len(img_ids), **summary}


if __name__ == "__main__":
    main()
