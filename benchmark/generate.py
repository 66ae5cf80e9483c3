"""The traffic generator: training steps and evaluation images made from
the seed and a traffic mix's parameters (``benchmark/traffic/<mix>.json``).

Everything is drawn from two generators derived from the seed: a NumPy
one on the host for counts, orders and labels, and a torch one on the
device for pixels and boxes, so the same seed gives the same inputs on the
same kind of device. Strata fix how many steps or images of each shape a
pool holds, so every seed does the same work in another order.

A training step's images take valid counts spread evenly over its
stratum's range, the same for every seed. Proposals are COB-like: integer boxes from 8 pixels to ``box_max_frac``
of a side (x1 uniform over the first 90 %), each with a full-resolution
mask (the ellipse inscribed in its box) and that mask's 7x7 nearest
rasterization over the box. A training image also gets the mask-IoU and
asymmetric-IoU matrices of its masks, one product an image, stored in
float16 as the loader ships them, 1-3 image labels (every class present
in the pool) and PCL clusters over its proposals.
"""
from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

# ToTensor normalization of the shipped configs (torchvision's ImageNet stats)
MEAN = torch.tensor([0.485, 0.456, 0.406])
STD = torch.tensor([0.229, 0.224, 0.225])


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's seed (any size of integer)."""
    d = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(d[:8], "little") & (2**63 - 1)


def _round_up(x: int, m: int) -> int:
    return int(math.ceil(x / m) * m)


def proposals(gen, n: int, hw, frac_max: float, min_side: int = 8):
    """n integer xyxy boxes (float32, on gen's device) in an (h, w) image."""
    h, w = hw
    dev = gen.device
    u = torch.rand((4, n), generator=gen, device=dev)
    x1 = torch.floor(u[0] * (0.9 * w))
    y1 = torch.floor(u[1] * (0.9 * h))
    x2 = torch.minimum(x1 + torch.floor(min_side + u[2] * (frac_max * w - min_side)),
                       torch.tensor(w - 1.0, device=dev))
    y2 = torch.minimum(y1 + torch.floor(min_side + u[3] * (frac_max * h - min_side)),
                       torch.tensor(h - 1.0, device=dev))
    return torch.stack([x1, y1, x2, y2], dim=-1)


def _inside(boxes, ys, xs):
    """(N, len(ys), len(xs)) bool: pixel centres inside each box's ellipse;
    ys / xs (N, k) or (k,) pixel indices."""
    cx = (boxes[:, 0] + boxes[:, 2] + 1) / 2
    cy = (boxes[:, 1] + boxes[:, 3] + 1) / 2
    rx = (boxes[:, 2] - boxes[:, 0] + 1) / 2
    ry = (boxes[:, 3] - boxes[:, 1] + 1) / 2
    xs = xs if xs.dim() == 2 else xs[None, :]
    ys = ys if ys.dim() == 2 else ys[None, :]
    dx = ((xs + 0.5 - cx[:, None]) / rx[:, None]) ** 2
    dy = ((ys + 0.5 - cy[:, None]) / ry[:, None]) ** 2
    return dy[:, :, None] + dx[:, None, :] <= 1.0


def masks_7x7(boxes, size: int = 7):
    """Each box's mask cropped to the box and nearest-resized to size x
    size (sample (i + 0.5) * side / size of the crop), float32."""
    bw = boxes[:, 2] - boxes[:, 0] + 1
    bh = boxes[:, 3] - boxes[:, 1] + 1
    k = torch.arange(size, device=boxes.device, dtype=torch.float32) + 0.5
    xs = boxes[:, 0:1] + torch.minimum(torch.floor(k[None, :] * bw[:, None] / size),
                                       bw[:, None] - 1)
    ys = boxes[:, 1:2] + torch.minimum(torch.floor(k[None, :] * bh[:, None] / size),
                                       bh[:, None] - 1)
    return _inside(boxes, ys, xs).float()


def iou_matrices(boxes, hw, chunk: int = 512):
    """(iou, asy) float32 (N, N) of the boxes' full-resolution masks:
    |a ∩ b| / |a ∪ b| and |a ∩ b| / |b|, 0 where the divisor is 0. The
    intersections are one product of the flattened 0/1 masks, exact in
    float32 and in TF32."""
    h, w = hw
    dev = boxes.device
    ys = torch.arange(h, device=dev, dtype=torch.float32)
    xs = torch.arange(w, device=dev, dtype=torch.float32)
    flat = torch.cat([_inside(boxes[i:i + chunk], ys, xs).reshape(-1, h * w).float()
                      for i in range(0, len(boxes), chunk)])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        inter = flat @ flat.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    area = flat.sum(-1)
    del flat
    union = area[:, None] + area[None, :] - inter
    iou = torch.where(union > 0, inter / union, torch.zeros_like(inter))
    ab = area[None, :].expand_as(inter)
    asy = torch.where(ab > 0, inter / ab, torch.zeros_like(inter))
    return iou, asy


def flip_boxes(boxes, width: int):
    return torch.stack([width - boxes[:, 2] - 1, boxes[:, 1], width - boxes[:, 0] - 1,
                        boxes[:, 3]], dim=-1)


def _labels(rng, n_images: int, classes: int, lo: int, hi: int):
    """lo-hi labels an image, then every absent class added to an image
    that has room."""
    labels = np.zeros((n_images, classes), np.float32)
    for i in range(n_images):
        labels[i, rng.choice(classes, rng.integers(lo, hi + 1), replace=False)] = 1
    for c in np.flatnonzero(labels.sum(0) == 0):
        room = np.flatnonzero((labels.sum(1) < hi) & (labels[:, c] == 0))
        labels[rng.choice(room) if len(room) else rng.integers(n_images), c] = 1
    return labels


def _clusters(rng, n: int, n_pad: int, labels, frac: float):
    """PCL cluster ids (n_pad, C+1): a cluster of frac * n proposals for
    each present class, and a background cluster in column 0."""
    mat = np.zeros((n_pad, len(labels) + 1), np.int32)
    cid = 1
    size = max(1, int(n * frac))
    for c in np.flatnonzero(labels):
        mat[rng.choice(n, size, replace=False), c + 1] = cid
        cid += 1
    mat[rng.choice(n, size, replace=False), 0] = cid
    return mat


def _host(t: torch.Tensor, pin: bool):
    t = t.cpu() if t.device.type != "cpu" else t
    return t.pin_memory() if pin else t.contiguous()


def train_pool(traffic: dict, model: dict, seed: int, device):
    """One training step for each stratum of the mix: {"batch": stacked
    (GRAD_ACCUM, ...) arrays in the program's layout (pinned host tensors
    on a card; ``image_hw`` a NumPy array), "meta": its stratum}."""
    device = torch.device(device)
    rng = np.random.default_rng(sub_seed(seed, "train_host"))
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "train_device"))
    accum = int(model["grad_accum"])
    strata = traffic["strata"]
    labels = _labels(rng, len(strata) * accum, model["classes"], *traffic["labels_per_image"])
    pin = device.type == "cuda"
    mean, std = MEAN.to(device), STD.to(device)
    pool = []
    for s_i, st in enumerate(strata):
        orig = tuple(st["image_hw"])
        scale = float(st["scale"]) / max(orig)
        true_hw = (int(round(orig[0] * scale)), int(round(orig[1] * scale)))
        bucket = (_round_up(true_hw[0], traffic["pad_multiple"]),
                  _round_up(true_hw[1], traffic["pad_multiple"]))
        n_pad = int(st["proposal_bucket"])
        lo, hi = st["n_valid"]
        # the same valid counts for every seed, evenly over the range, in a
        # seeded order: the seed changes the order and the boxes, not the work
        counts = [lo + int(round((k + 0.5) * (hi - lo) / accum)) for k in range(accum)]
        mbs = []
        for j in rng.permutation(accum):
            n = counts[j]
            boxes = proposals(gen, n, orig, traffic["box_max_frac"])
            iou, asy = iou_matrices(boxes, orig)
            m7 = masks_7x7(boxes)
            if rng.random() < traffic["hflip_p"]:
                boxes, m7 = flip_boxes(boxes, orig[1]), torch.flip(m7, [-1])
            pix = torch.randint(0, 256, true_hw + (3,), generator=gen, device=device,
                                dtype=torch.uint8)
            image = torch.zeros(bucket + (3,), device=device)
            image[:true_hw[0], :true_hw[1]] = (pix.float() / 255.0 - mean) / std
            lab = labels[s_i * accum + j]
            mb = {
                "image": image,
                "rois": torch.zeros((n_pad, 4), device=device),
                "masks": torch.zeros((n_pad, 7, 7), device=device),
                "valid": torch.arange(n_pad, device=device) < n,
                "labels": torch.from_numpy(lab).to(device),
                "mat": torch.from_numpy(_clusters(rng, n, n_pad, lab,
                                                  traffic["cluster_frac"])).to(device),
                "iou_map": torch.zeros((n_pad, n_pad), dtype=torch.float16, device=device),
                "asy_iou_map": torch.zeros((n_pad, n_pad), dtype=torch.float16,
                                           device=device),
            }
            mb["rois"][:n] = boxes * torch.tensor(np.float32(scale), device=device)
            mb["masks"][:n] = m7
            mb["iou_map"][:n, :n] = iou.half()
            mb["asy_iou_map"][:n, :n] = asy.half()
            mbs.append((mb, true_hw))
            del iou, asy
        batch = {k: _host(torch.stack([mb[k] for mb, _ in mbs]), pin) for k in mbs[0][0]}
        batch["image_hw"] = np.array([hw for _, hw in mbs], np.int32)
        pool.append({"batch": batch, "meta": {
            "scale": int(st["scale"]), "image_hw": list(orig), "bucket": list(bucket),
            "proposal_bucket": n_pad, "weight": int(st.get("weight", 1))}})
    return pool


def train_checked(pool, seed: int, k: int):
    """The k pool steps the check follows, in the order they run: a step of
    the largest scale at the largest proposal bucket, then steps of scales
    not drawn yet while any is left; each pick (and its image shape and
    bucket) drawn from the seed, so the seeds reach every stratum."""
    rng = np.random.default_rng(sub_seed(seed, "train_checked"))
    metas = [st["meta"] for st in pool]
    top = max((m["scale"], m["proposal_bucket"]) for m in metas)
    chosen = [int(rng.choice([i for i, m in enumerate(metas)
                              if (m["scale"], m["proposal_bucket"]) == top]))]
    while len(chosen) < min(k, len(pool)):
        scales = {metas[i]["scale"] for i in chosen}
        rest = [i for i in range(len(pool)) if i not in chosen]
        chosen.append(int(rng.choice([i for i in rest if metas[i]["scale"] not in scales]
                                     or rest)))
    return chosen


def train_walk(traffic: dict, pool, seed: int):
    """The pool's steps in the window's order: cycles in which each step
    comes ``weight`` times, each cycle shuffled anew."""
    rng = np.random.default_rng(sub_seed(seed, "train_walk"))
    cycle = [i for i, st in enumerate(pool) for _ in range(int(st["meta"]["weight"]))]
    while True:
        yield from rng.permutation(cycle).tolist()


def eval_pool(traffic: dict, seed: int, device):
    """The mix's windows of images: per window, each stratum's count of
    landscape and portrait images with proposal counts uniform in its
    range, shuffled. An image is (uint8 BGR (h, w, 3), boxes (n, 4)
    float32, masks (n, 7, 7) float32), NumPy on the host."""
    device = torch.device(device)
    rng = np.random.default_rng(sub_seed(seed, "eval_host"))
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "eval_device"))
    windows = []
    for _ in range(int(traffic["windows"])):
        specs = [(tuple(shape), st["n_valid"]) for st in traffic["strata"]
                 for shape, count in zip(traffic["image_shapes"], st["counts"])
                 for _ in range(count)]
        items = []
        for k in rng.permutation(len(specs)):
            hw, (lo, hi) = specs[k]
            n = int(rng.integers(lo, hi + 1))
            boxes = proposals(gen, n, hw, traffic["box_max_frac"])
            image = torch.randint(0, 256, hw + (3,), generator=gen, device=device,
                                  dtype=torch.uint8)
            items.append((image.cpu().numpy(), boxes.cpu().numpy(),
                          masks_7x7(boxes).cpu().numpy()))
        windows.append(items)
    return windows
