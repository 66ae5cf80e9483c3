"""COCO run-length-encoding codec (numpy; format-compatible with
pycocotools).

pycocotools is not vendored; this module implements the same on-disk
format (the base-48 LEB-style "counts" strings produced by maskApi.c
rleToString/rleFrString) so result JSONs interoperate with standard COCO
tooling. Used by the instance-segmentation evaluator
(reference tools/evaluation.py:119-138 coco_encode path,
lib/utils/mask_eval_utils.py:112-117) and the pseudo-label exporter.
"""
from __future__ import annotations

import numpy as np

try:  # C++ fast paths (cim_tpu_torch.native builds lazily with g++)
    from cim_tpu_torch import native as _native

    _native._load()
except Exception:  # pragma: no cover - no compiler on host
    _native = None


def mask_to_rle_counts(mask: np.ndarray) -> list:
    """(H, W) {0,1} mask -> uncompressed RLE counts (column-major, starting
    with the zero run)."""
    try:
        from cim_tpu_torch.native import rle_encode_counts

        return rle_encode_counts(np.asarray(mask, np.uint8))
    except Exception:
        pass
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    n = flat.size
    if n == 0:
        return [0]
    change = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [n]])).tolist()
    if flat[0] == 1:
        runs = [0] + runs
    return runs


def rle_counts_to_mask(counts, h: int, w: int) -> np.ndarray:
    if _native is not None:
        return _native.rle_decode_mask(counts, h, w)
    counts = np.asarray(counts, np.int64)
    # vectorized: repeat the alternating 0/1 value pattern by run lengths
    vals = (np.arange(len(counts), dtype=np.uint8) & 1)
    flat = np.repeat(vals, counts)
    if flat.size < h * w:
        flat = np.pad(flat, (0, h * w - flat.size))
    return flat[: h * w].reshape((h, w), order="F")


def counts_to_string(counts) -> str:
    """Compress counts to the COCO string form (maskApi.c rleToString)."""
    if _native is not None:
        return _native.rle_to_string(counts)
    out = []
    cnts = list(counts)
    for i, x in enumerate(cnts):
        if i > 2:
            x -= cnts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def string_to_counts(s: str) -> list:
    """Decompress a COCO counts string (maskApi.c rleFrString)."""
    if _native is not None:
        return _native.rle_from_string(s).tolist()
    cnts = []
    i = 0
    m = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if m > 2:
            x += cnts[m - 2]
        cnts.append(x)
        m += 1
    return cnts


def encode(mask: np.ndarray) -> dict:
    """(H, W) mask -> {'size': [H, W], 'counts': str} (compressed RLE)."""
    h, w = mask.shape
    return {
        "size": [int(h), int(w)],
        "counts": counts_to_string(mask_to_rle_counts(mask)),
    }


def decode(rle: dict) -> np.ndarray:
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = string_to_counts(counts)
    elif isinstance(counts, bytes):
        counts = string_to_counts(counts.decode("ascii"))
    return rle_counts_to_mask(counts, h, w)


def area(rle: dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = string_to_counts(
            counts if isinstance(counts, str) else counts.decode("ascii")
        )
    return int(sum(counts[1::2]))


def to_bbox(rle: dict) -> np.ndarray:
    """RLE -> xywh bbox (maskApi.c rleToBbox semantics), computed from the
    run counts without decoding the mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = string_to_counts(
            counts if isinstance(counts, str) else counts.decode("ascii")
        )
    counts = np.asarray(counts, np.int64)
    if h == 0 or w == 0 or counts[1::2].sum() == 0:
        return np.zeros(4, np.float32)
    ends = np.cumsum(counts)
    starts = ends - counts
    s1, e1 = starts[1::2], ends[1::2] - 1  # 1-runs: first/last linear pos
    keep = e1 >= s1
    s1, e1 = s1[keep], e1[keep]
    x0, x1 = s1 // h, e1 // h
    # a run confined to one column bounds y by its own extent; a run
    # crossing a column boundary spans the full height
    same = x0 == x1
    ymin = np.where(same, s1 % h, 0).min()
    ymax = np.where(same, e1 % h, h - 1).max()
    return np.array(
        [x0.min(), ymin, x1.max() - x0.min() + 1, ymax - ymin + 1],
        np.float32,
    )


def _trunc_int(a):
    """C-style (int) cast: truncation toward zero."""
    return np.trunc(a).astype(np.int64)


def poly_to_rle(poly, h: int, w: int) -> dict:
    """Single polygon [x0, y0, x1, y1, ...] -> compressed RLE dict.

    Reimplements the pycocotools maskApi.c ``rleFrPoly`` rasterization
    semantics (the reference depends on it via
    ``pycocotools.mask.frPyObjects``, used at
    reference lib/datasets/json_inference.py:54 and
    lib/utils/mask_eval_utils.py:112-117): the boundary is upsampled x5,
    drawn with a rounding DDA, reduced to column-crossing events, and the
    sorted column-major crossing positions define the even-odd fill runs.
    """
    xy = np.asarray(poly, np.float64).reshape(-1, 2)
    k = xy.shape[0]
    scale = 5.0
    x = _trunc_int(scale * xy[:, 0] + 0.5)
    y = _trunc_int(scale * xy[:, 1] + 0.5)
    x = np.append(x, x[0])
    y = np.append(y, y[0])

    # dense boundary points along every edge (rounding DDA, both axes)
    us, vs = [], []
    for j in range(k):
        xs, xe, ys, ye = int(x[j]), int(x[j + 1]), int(y[j]), int(y[j + 1])
        dx, dy = abs(xe - xs), abs(ys - ye)
        flip = (dx >= dy and xs > xe) or (dx < dy and ys > ye)
        if flip:
            xs, xe = xe, xs
            ys, ye = ye, ys
        if dx >= dy:
            s = (ye - ys) / dx if dx else 0.0
            d = np.arange(dx + 1, dtype=np.int64)
            t = dx - d if flip else d
            us.append(t + xs)
            vs.append(_trunc_int(ys + s * t + 0.5))
        else:
            s = (xe - xs) / dy if dy else 0.0
            d = np.arange(dy + 1, dtype=np.int64)
            t = dy - d if flip else d
            vs.append(t + ys)
            us.append(_trunc_int(xs + s * t + 0.5))
    u = np.concatenate(us)
    v = np.concatenate(vs)

    # column-crossing events, downsampled back to pixel resolution
    du = u[1:] != u[:-1]
    xd = np.where(u[1:] < u[:-1], u[1:], u[1:] - 1).astype(np.float64)
    xd = (xd + 0.5) / scale - 0.5
    yd = np.minimum(v[1:], v[:-1]).astype(np.float64)
    yd = (yd + 0.5) / scale - 0.5
    keep = du & (np.floor(xd) == xd) & (xd >= 0) & (xd <= w - 1)
    xd = xd[keep]
    yd = np.ceil(np.clip(yd[keep], 0, h))

    # even-odd fill: sorted column-major crossing positions toggle the value
    a = np.sort(xd.astype(np.int64) * h + yd.astype(np.int64))
    a = np.append(a, h * w)
    gaps = np.diff(np.concatenate([[0], a])).tolist()
    counts = [gaps[0]]
    j = 1
    while j < len(gaps):
        if gaps[j] > 0:
            counts.append(gaps[j])
            j += 1
        else:  # double crossing at one position: runs merge
            j += 1
            if j < len(gaps):
                counts[-1] += gaps[j]
                j += 1
    return {"size": [int(h), int(w)], "counts": counts_to_string(counts)}


def merge(rles: list, intersect: bool = False) -> dict:
    """Union (or intersection) of RLEs (pycocotools mask.merge).

    An empty list yields an empty (size [0, 0]) mask rather than raising —
    some datasets carry annotations with ``"segmentation": []``."""
    if not rles:
        return encode(np.zeros((0, 0), np.uint8))
    if len(rles) == 1:
        return rles[0]
    m = decode(rles[0]).astype(bool)
    for r in rles[1:]:
        m = (m & decode(r).astype(bool)) if intersect else (m | decode(r).astype(bool))
    return encode(m.astype(np.uint8))


def fr_poly_objects(segm, h: int, w: int) -> dict:
    """pycocotools ``frPyObjects`` + ``merge`` for one annotation's
    segmentation: list-of-polygons -> merged RLE; uncompressed RLE dict
    (list counts) -> compressed RLE; compressed passes through."""
    if isinstance(segm, dict):
        counts = segm["counts"]
        if isinstance(counts, (list, tuple)):
            return {
                "size": list(segm["size"]),
                "counts": counts_to_string(counts),
            }
        return segm
    # polygons: [[x0, y0, ...], ...]
    return merge([poly_to_rle(p, h, w) for p in segm])


def iou_rle(dts: list, gts: list, iscrowd=None) -> np.ndarray:
    """Pairwise mask IoU between RLE lists (pycocotools mask.iou semantics:
    for crowd gt, the union is just the dt area)."""
    d = len(dts)
    g = len(gts)
    out = np.zeros((d, g), np.float64)
    if d == 0 or g == 0:
        return out
    if _native is not None:
        # the native run-walk compares counts positionally and never sees
        # 'size' — dt/gt RLEs from different canvases would silently
        # produce wrong IoUs where the decode fallback raises, so check
        # canvas agreement up front
        sizes = {tuple(r["size"]) for r in dts} | {tuple(r["size"]) for r in gts}
        if len(sizes) > 1:
            raise ValueError(
                f"iou_rle: RLEs span multiple canvases {sorted(sizes)}; "
                "all dt/gt masks must share one (h, w)"
            )

        def _cnts(r):
            c = r["counts"]
            if isinstance(c, bytes):
                c = c.decode("ascii")
            return string_to_counts(c) if isinstance(c, str) else c

        return _native.rle_iou_counts(
            [_cnts(r) for r in dts], [_cnts(r) for r in gts], iscrowd
        )
    dm = [decode(r).astype(bool) for r in dts]
    gm = [decode(r).astype(bool) for r in gts]
    da = [m.sum() for m in dm]
    ga = [m.sum() for m in gm]
    for j in range(g):
        crowd = bool(iscrowd[j]) if iscrowd is not None else False
        for i in range(d):
            inter = np.logical_and(dm[i], gm[j]).sum()
            union = da[i] if crowd else da[i] + ga[j] - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out
