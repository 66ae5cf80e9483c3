"""Host-side image preprocessing.

Behavior contracts: lib/utils/blob.py prep_im_for_blob (:93-147) — two
modes selected by cfg.transform_mode:
- "org": float32 BGR minus Detectron pixel means (config.py:480);
- "ToTensor": resize as uint8, BGR->RGB, /255, torchvision
  Normalize(mean=(0.485,0.456,0.406), std=(0.229,0.224,0.225)) — the mode
  all shipped configs use (configs/resnet50_voc.yaml:9).
Scale: target / max side; the max_size cap is commented out upstream
(blob.py:162-169) and therefore absent here too.
"""
from __future__ import annotations

import numpy as np

try:
    import cv2

    cv2.setNumThreads(0)  # dataloader-deadlock guard (reference train.py:19)
    _HAVE_CV2 = True
except Exception:  # pragma: no cover
    _HAVE_CV2 = False

TORCH_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
TORCH_STD = np.array([0.229, 0.224, 0.225], np.float32)


def scale_for_target(shape_hw, target_size, max_size) -> float:
    """target / longest side (reference get_target_scale, blob.py:162-169)."""
    del max_size  # cap is disabled upstream
    im_size_max = float(max(shape_hw[0], shape_hw[1]))
    return float(target_size) / im_size_max


def _resize(im, scale, interpolation):
    if _HAVE_CV2:
        return cv2.resize(
            im, None, None, fx=scale, fy=scale, interpolation=interpolation
        )
    # PIL fallback (bilinear)
    from PIL import Image

    h, w = im.shape[:2]
    out_size = (int(w * scale), int(h * scale))
    return np.asarray(
        Image.fromarray(im.astype(np.uint8)).resize(out_size, Image.BILINEAR)
    )


def aspect_ratio_rel(im, aspect_ratio: float):
    """Width-relative aspect-ratio distortion (reference
    lib/utils/image.py aspect_ratio_rel)."""
    h, w = im.shape[:2]
    new_w = int(round(w * aspect_ratio))
    if _HAVE_CV2:
        return cv2.resize(im, (new_w, h), interpolation=cv2.INTER_LINEAR)
    from PIL import Image

    return np.asarray(
        Image.fromarray(im.astype(np.uint8)).resize((new_w, h), Image.BILINEAR)
    )


def _resize_totensor_uint8(im, scale, interp):
    """The reference resizes the float32 image and truncates to uint8
    (blob.py:117-128: astype(float32) -> cv2.resize -> np.uint8), which
    differs from resizing the uint8 directly (cv2 rounds internally) by
    +/-1 in ~half the pixels. Replicate the float-resize-then-truncate
    order for pixel-exact parity."""
    return np.uint8(_resize(im.astype(np.float32), scale, interp))


def prep_image_uint8_rgb(im, scale):
    """Host half of the "ToTensor" transform: resize + BGR->RGB, staying
    uint8. The /255 + mean/std normalization runs on device
    (cim_tpu.engine.test.Evaluator._forward) — 4x less host->device
    transfer and no single-core float math per TTA pass."""
    interp = cv2.INTER_LINEAR if _HAVE_CV2 else None
    im_r = _resize_totensor_uint8(im, scale, interp) if scale != 1.0 else im
    return np.ascontiguousarray(im_r[:, :, ::-1])


def prep_image(im, scale, mode: str, pixel_means=None):
    """im: (H, W, 3) uint8 BGR -> resized float32 (h, w, 3)."""
    interp = cv2.INTER_LINEAR if _HAVE_CV2 else None
    if mode == "org":
        imf = im.astype(np.float32)
        if pixel_means is not None:
            imf = imf - np.asarray(pixel_means, np.float32).reshape(1, 1, 3)
        return _resize(imf, scale, interp) if scale != 1.0 else imf
    if mode == "ToTensor":
        im_r = _resize_totensor_uint8(im, scale, interp) if scale != 1.0 else im
        im_rgb = im_r[:, :, ::-1].astype(np.float32) / 255.0
        return (im_rgb - TORCH_MEAN) / TORCH_STD
    raise AssertionError(f"prep_image: unknown transform_mode {mode!r}")
