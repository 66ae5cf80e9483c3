"""ctypes bindings for the native host kernels (host_kernels.cpp).

The port's own copy of cim_tpu/native (same source, same bindings). It
builds with g++ at first use into ``cim_tpu_torch/_build/``, named by a
hash of the source and the flags, so an edited source builds anew and
concurrent builders never see half a file. Callers that must run without
a compiler (evaluation.rle) catch the failure and keep their numpy paths.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "host_kernels.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-march=native")

_lib = None


def _build() -> str:
    """Compile host_kernels.cpp unless a library of the same source and
    flags exists; returns the library's path."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(_BUILD_DIR, f"host_kernels_{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True, capture_output=True)
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_build())
    lib.nms.restype = ctypes.c_int
    lib.nms.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.bbox_overlaps.restype = None
    lib.bbox_overlaps.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.rle_encode.restype = ctypes.c_int
    lib.rle_encode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.soft_nms.restype = ctypes.c_int
    lib.soft_nms.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.rle_to_string.restype = ctypes.c_int
    lib.rle_to_string.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int, ctypes.c_char_p,
    ]
    lib.rle_from_string.restype = ctypes.c_int
    lib.rle_from_string.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.rle_decode.restype = None
    lib.rle_decode.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.rle_iou.restype = None
    lib.rle_iou.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double),
    ]
    _lib = lib
    return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def nms(dets: np.ndarray, thresh: float) -> np.ndarray:
    """Greedy NMS (cython_nms semantics). Returns kept indices in
    descending score order."""
    lib = _load()
    dets = np.ascontiguousarray(dets, np.float32)
    n = dets.shape[0]
    keep = np.empty(n, np.int32)
    count = lib.nms(_ptr(dets, ctypes.c_float), n, float(thresh),
                    _ptr(keep, ctypes.c_int))
    return keep[:count].copy()


def bbox_overlaps(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    lib = _load()
    boxes = np.ascontiguousarray(boxes, np.float32)
    query = np.ascontiguousarray(query, np.float32)
    out = np.empty((boxes.shape[0], query.shape[0]), np.float32)
    lib.bbox_overlaps(
        _ptr(boxes, ctypes.c_float), boxes.shape[0],
        _ptr(query, ctypes.c_float), query.shape[0],
        _ptr(out, ctypes.c_float),
    )
    return out


def rle_encode_counts(mask: np.ndarray) -> list:
    """(H, W) mask -> column-major RLE counts (pycocotools order)."""
    lib = _load()
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    out = np.empty(h * w + 1, np.uint32)
    m = lib.rle_encode(_ptr(mask, ctypes.c_uint8), h, w,
                       _ptr(out, ctypes.c_uint32))
    return out[:m].tolist()


def soft_nms(dets: np.ndarray, sigma=0.5, nt=0.3, threshold=0.001,
             method=1):
    lib = _load()
    boxes = np.ascontiguousarray(dets, np.float32).copy()
    n = boxes.shape[0]
    inds = np.empty(n, np.int32)
    count = lib.soft_nms(
        _ptr(boxes, ctypes.c_float), n, float(sigma), float(nt),
        float(threshold), int(method), _ptr(inds, ctypes.c_int),
    )
    return boxes[:count].copy(), inds[:count].copy()


def rle_to_string(counts) -> str:
    """Counts -> COCO LEB base-48 string (maskApi.c rleToString)."""
    lib = _load()
    c = np.ascontiguousarray(counts, np.uint32)
    out = ctypes.create_string_buffer(8 * max(len(c), 1))
    n = lib.rle_to_string(_ptr(c, ctypes.c_uint32), len(c), out)
    return out.raw[:n].decode("ascii")


def rle_from_string(s: str) -> np.ndarray:
    """COCO counts string -> uint32 counts array."""
    lib = _load()
    b = s.encode("ascii")
    out = np.empty(max(len(b), 1), np.uint32)
    m = lib.rle_from_string(b, len(b), _ptr(out, ctypes.c_uint32))
    return out[:m].copy()


def rle_decode_mask(counts, h: int, w: int) -> np.ndarray:
    """Column-major counts -> (h, w) uint8 mask."""
    lib = _load()
    c = np.ascontiguousarray(counts, np.uint32)
    mask = np.zeros((h, w), np.uint8)
    lib.rle_decode(_ptr(c, ctypes.c_uint32), len(c), h, w,
                   _ptr(mask, ctypes.c_uint8))
    return mask


def rle_iou_counts(dt_counts_list, gt_counts_list, iscrowd=None) -> np.ndarray:
    """Pairwise mask IoU straight from RLE counts (no mask decode):
    the pycocotools mask.iou semantics (crowd gt -> union = dt area)."""
    lib = _load()
    d, g = len(dt_counts_list), len(gt_counts_list)
    out = np.zeros((d, g), np.float64)
    if d == 0 or g == 0:
        return out

    def pack(lists):
        off = np.zeros(len(lists) + 1, np.int32)
        for i, c in enumerate(lists):
            off[i + 1] = off[i] + len(c)
        flat = np.empty(max(int(off[-1]), 1), np.uint32)
        for i, c in enumerate(lists):
            flat[off[i] : off[i + 1]] = np.asarray(c, np.uint32)
        return flat, off

    dflat, doff = pack(dt_counts_list)
    gflat, goff = pack(gt_counts_list)
    crowd = np.zeros(g, np.uint8)
    if iscrowd is not None:
        crowd[:] = np.asarray(iscrowd, np.uint8)
    lib.rle_iou(
        _ptr(dflat, ctypes.c_uint32), _ptr(doff, ctypes.c_int), d,
        _ptr(gflat, ctypes.c_uint32), _ptr(goff, ctypes.c_int), g,
        _ptr(crowd, ctypes.c_uint8), _ptr(out, ctypes.c_double),
    )
    return out
