"""Filter pseudo-label annotations by score (port of tools/change_mask_thr.py;
reference tools/change_mask_thr.py:6-41; the shipped pipeline uses 0.3,
scripts/generate_msrcnn_label.sh).

    python -m cim_tpu_torch.tools.change_mask_thr --input msrcnn_pseudo_label.json --thr 0.3

Keeps the annotations whose score is at least --thr, renumbers their ids
densely from 1 and keeps every image. Writes --output, by default the
input's name with _thr<thr> before .json.
"""
from __future__ import annotations

import argparse

from cim_tpu_torch.utils.io import load_json, save_json


def main(argv=None):
    """Run the CLI; returns the path of the JSON written."""
    parser = argparse.ArgumentParser(description="Filter pseudo labels by score")
    parser.add_argument("--input", required=True, help="msrcnn_pseudo_label.json")
    parser.add_argument("--output", default=None)
    parser.add_argument("--thr", type=float, default=0.3)
    args = parser.parse_args(argv)

    data = load_json(args.input)
    before = len(data["annotations"])
    data["annotations"] = [a for a in data["annotations"] if a.get("score", 1.0) >= args.thr]
    # the reference renumbers the survivors' ids from 1 (:30-37)
    for j, a in enumerate(data["annotations"], start=1):
        a["id"] = j
    out = args.output or args.input.replace(".json", f"_thr{args.thr:g}.json")
    save_json(data, out)
    print(f"kept {len(data['annotations'])}/{before} annotations (thr={args.thr}) -> {out}")
    return out


if __name__ == "__main__":
    main()
