"""Point-level label assignment (CIM-p): annotated points -> cluster matrix
(port of tools/pre/point_level_label_assign.py; reference
tools/pre/point_level_label_assign.py:24-103).

    python -m cim_tpu_torch.tools.pre.point_level_label_assign --ann_file data/voc/trainaug.json \\
        --cob_dir data/VOC2012/COB --points_dir data/VOC2012/Center_points \\
        --output data/label_assign/voc_2012_point_label_assign.pkl [--device cpu]

The AGPL rule (AGPL_label_assign.assign_cluster_sites, on --device) with
the PRM's peaks replaced by the points of <points_dir>/<image>.txt, lines
"x y class [conf]", applied in file order.
"""
from __future__ import annotations

import argparse
import os
import pickle

from cim_tpu_torch.evaluation.coco import COCO
from cim_tpu_torch.tools.pre.AGPL_label_assign import assign_cluster_sites
from cim_tpu_torch.tools.pre.generate_7_7 import load_cob_mat, mat_path_for
from cim_tpu_torch.utils.device import resolve_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Point-level label assignment")
    parser.add_argument("--ann_file", required=True)
    parser.add_argument("--cob_dir", required=True)
    parser.add_argument("--points_dir", required=True,
                        help="Center_points directory of <image>.txt files")
    parser.add_argument("--output", required=True)
    parser.add_argument("--num_classes", type=int, default=20)
    parser.add_argument("--dataset", choices=["voc", "coco"], default="voc")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return parser.parse_args(argv)


def assign_from_points(mask_proposals, points, num_classes, device="cuda"):
    """points: (x, y, class_idx, conf) in file order (reference
    point_level_label_assign.py:66-95, the AGPL loop)."""
    sites = [(int(y), int(x), class_idx) for x, y, class_idx, _conf in points]
    return assign_cluster_sites(mask_proposals, sites, num_classes, device)


def read_points(txt):
    """[(x, y, class, conf)] of a points file (conf 1.0 where a line has
    none); [] where there is no file."""
    points = []
    if os.path.exists(txt):
        with open(txt) as pf:
            for line in pf.read().splitlines():
                p = line.strip().split(" ")
                if len(p) >= 3:
                    points.append((float(p[0]), float(p[1]), int(p[2]),
                                   float(p[3]) if len(p) > 3 else 1.0))
    return points


def main(argv=None):
    """Returns {output, n_images, n_points}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    img_ids = sorted(COCO(args.ann_file).getImgIds())
    out = {"indexes": [], "mat": []}
    n_points = []
    for k, img_id in enumerate(img_ids):
        masks = load_cob_mat(mat_path_for(args.cob_dir, img_id, args.dataset))
        s = str(int(img_id))
        name = s[:4] + "_" + s[4:] if args.dataset == "voc" else f"{int(img_id):012d}"
        points = read_points(os.path.join(args.points_dir, name + ".txt"))
        out["indexes"].append(img_id)
        out["mat"].append(assign_from_points(masks, points, args.num_classes, device))
        n_points.append(len(points))
        if k % 100 == 0:
            print(f"{k + 1}/{len(img_ids)}", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with open(args.output, "wb") as f:
        pickle.dump(out, f, pickle.HIGHEST_PROTOCOL)
    print(f"wrote {len(out['indexes'])} mats -> {args.output}")
    return {"output": args.output, "n_images": len(img_ids), "n_points": n_points}


if __name__ == "__main__":
    main()
