"""Rasterize full-resolution COB proposals to MASK_SIZE x MASK_SIZE crops
(port of tools/pre/generate_7_7.py; reference
tools/pre/generate_7_7_voc.py:14-47).

    python -m cim_tpu_torch.tools.pre.generate_7_7 --ann_file data/voc/trainaug.json \\
        --cob_dir data/VOC2012/COB --output data/proposals/trainaug_7x7.pkl

For each image of the annotation file, in id order: its COB .mat, each
mask's tight box, the crop nearest-resized to SxS. Writes one pkl
{indexes, boxes, masks, scores}, the TRAIN/TEST.PROPOSAL_FILES input.
Host only: no tensor goes to a card. Images are spread over --nprocs
workers from a spawn context (main() may run in a process that has
initialised CUDA); a script that calls main() with --nprocs > 1 needs an
``if __name__ == "__main__"`` guard, since a spawned worker imports it.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import pickle
import time

import numpy as np
from scipy.io import loadmat

from cim_tpu_torch.data.synthetic import masks_to_7x7


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Generate SxS proposal masks")
    parser.add_argument("--ann_file", required=True,
                        help="COCO-json annotation file (image list source)")
    parser.add_argument("--cob_dir", required=True, help="directory of COB .mat proposals")
    parser.add_argument("--output", required=True, help="output pkl")
    parser.add_argument("--mask_size", type=int, default=7)
    parser.add_argument("--dataset", choices=["voc", "coco"], default="voc")
    parser.add_argument("--nprocs", type=int, default=8)
    return parser.parse_args(argv)


def mat_path_for(cob_dir, img_id, dataset):
    """The .mat of an image id: YYYY_NNNNNN.mat (voc) or the id in 12
    digits (coco)."""
    if dataset == "voc":
        s = str(int(img_id))
        return os.path.join(cob_dir, s[:4] + "_" + s[4:] + ".mat")
    return os.path.join(cob_dir, f"{int(img_id):012d}.mat")


def load_cob_mat(path) -> np.ndarray:
    """(N, H, W) bool proposal masks of a COB .mat (cell array maskmat)."""
    mat = loadmat(path, verify_compressed_data_integrity=False)["maskmat"]
    proposals = mat[:, 0] if mat.ndim == 2 else mat
    return np.stack([np.asarray(p, bool) for p in proposals])


def rasterize_one(payload):
    """(img_id, boxes (N, 4) uint16, masks (N, S, S) bool, scores (N,)) of
    one image; payload (img_id, cob_dir, dataset, mask_size)."""
    img_id, cob_dir, dataset, mask_size = payload
    masks = load_cob_mat(mat_path_for(cob_dir, img_id, dataset))
    n = masks.shape[0]
    # crop with INCLUSIVE extents; the STORED boxes use the reference's
    # exclusive-max convention [xmin, ymin, xmax+1, ymax+1] uint16
    # (generate_7_7_voc.py:36-40): the clip in json_dataset trims only a
    # box touching the border, so interior training boxes carry the +1
    incl = np.zeros((n, 4), np.float32)
    for i in range(n):
        ys, xs = np.nonzero(masks[i])
        # the reference fails on min() of an empty set
        # (generate_7_7_voc.py:36): an empty COB mask is corrupt input
        # (cim_tpu's assert, raised also under python -O)
        if len(ys) == 0:
            raise AssertionError(f"empty COB proposal mask #{i} for image {img_id}")
        incl[i] = [xs.min(), ys.min(), xs.max(), ys.max()]
    small = masks_to_7x7(masks, incl, mask_size)
    boxes = incl.astype(np.uint16)
    boxes[:, 2:] += 1
    # the reference writes all-zero scores (generate_7_7_voc.py:33)
    scores = np.zeros(n)
    return img_id, boxes, small.astype(bool), scores


def image_ids(ann_file):
    """The annotation file's image ids, sorted."""
    with open(ann_file) as f:
        return sorted(im["id"] for im in json.load(f)["images"])


def main(argv=None):
    """Returns {output, n_images, seconds}."""
    args = parse_args(argv)
    t0 = time.perf_counter()
    work = [(i, args.cob_dir, args.dataset, args.mask_size) for i in image_ids(args.ann_file)]
    if args.nprocs > 1:
        with mp.get_context("spawn").Pool(args.nprocs) as pool:
            outs = pool.map(rasterize_one, work)
    else:
        outs = [rasterize_one(w) for w in work]

    proposals = {
        "indexes": [o[0] for o in outs],
        "boxes": [o[1] for o in outs],
        "masks": [o[2] for o in outs],
        "scores": [o[3] for o in outs],
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with open(args.output, "wb") as f:
        pickle.dump(proposals, f, pickle.HIGHEST_PROTOCOL)
    print(f"wrote {len(outs)} images -> {args.output}")
    return {"output": args.output, "n_images": len(outs), "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    main()
