"""The port's device resize and box transforms against cim_tpu's, on the
CPU; and its gather-form resize against its matrix form, at
tests/test_image_resize.py's cases and bound (rtol 1e-6, atol 1e-3: the
same taps, float32 sums in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cim_tpu.ops.boxes import aspect_ratio as jax_aspect_ratio
from cim_tpu.ops.boxes import flip_boxes as jax_flip_boxes
from cim_tpu.ops.image import resize_bilinear_dynamic as jax_resize
from cim_tpu.ops.image import resize_bilinear_gather as jax_resize_gather
from cim_tpu_torch.ops.boxes import aspect_ratio, flip_boxes
from cim_tpu_torch.ops.image import resize_bilinear_dynamic, resize_bilinear_gather


@pytest.mark.parametrize("hflip", [False, True])
@pytest.mark.parametrize(
    "target, canvas", [(96, (128, 128)), (160, (128, 192)), (48, (64, 64))],
    ids=["identity", "up", "down"],
)
def test_resize_matches_jax(rng, hflip, target, canvas):
    """A 75x100 image in a 128x128 bucket, resized by target / max_side
    onto a pass canvas; uint8 values as the eval path feeds them."""
    h, w = 75, 100
    bucket = np.zeros((128, 128, 3), np.float32)
    bucket[:h, :w] = rng.randint(0, 256, (h, w, 3))
    scale = np.float32(target) / np.float32(max(h, w))
    want, (wh, ww) = jax_resize(jnp.asarray(bucket), canvas, scale, (h, w), hflip=hflip)
    got, (gh, gw) = resize_bilinear_dynamic(
        torch.from_numpy(bucket), canvas, scale, (h, w), hflip=hflip
    )
    assert (gh, gw) == (int(wh), int(ww))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_flip_boxes_matches_jax(rng):
    boxes = rng.uniform(0, 90, (11, 4)).astype(np.float32)
    want = np.asarray(jax_flip_boxes(jnp.asarray(boxes), 100))
    got = flip_boxes(torch.from_numpy(boxes), 100).numpy()
    np.testing.assert_array_equal(got, want)


def test_aspect_ratio_matches_jax(rng):
    boxes = rng.uniform(0, 90, (11, 4)).astype(np.float32)
    want = np.asarray(jax_aspect_ratio(jnp.asarray(boxes), 0.75))
    np.testing.assert_array_equal(aspect_ratio(torch.from_numpy(boxes), 0.75).numpy(), want)


@pytest.mark.parametrize("hflip", [False, True])
@pytest.mark.parametrize(
    "src_hw,valid_hw,out_hw,target",
    [
        ((128, 128), (96, 128), (256, 192), 250.0),  # upscale
        ((128, 128), (128, 100), (64, 64), 40.0),  # downscale
        ((128, 128), (128, 128), (128, 128), 128.0),  # identity-ish
        ((64, 128), (50, 127), (192, 320), 300.0),  # odd extents
        ((32, 32), (1, 32), (64, 64), 48.0),  # 1-row source (edge clamp)
    ],
)
def test_gather_matches_matmul(src_hw, valid_hw, out_hw, target, hflip):
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.rand(*src_hw, 3).astype(np.float32) * 255.0)
    scale = np.float32(target) / np.float32(max(valid_hw))
    got, ghw = resize_bilinear_gather(img, out_hw, scale, valid_hw, hflip=hflip)
    want, whw = resize_bilinear_dynamic(img, out_hw, scale, valid_hw, hflip=hflip)
    assert ghw == whw
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-3)


def test_gather_matches_jax_gather():
    """One upscaled, flipped case against cim_tpu's gather form: the same
    float32 taps and weights, summed in the same order (bound 1e-4 of the
    255 range, as test_resize_matches_jax)."""
    rng = np.random.RandomState(1)
    img = rng.rand(64, 128, 3).astype(np.float32) * 255.0
    scale = np.float32(300.0) / np.float32(127)
    want, (wh, ww) = jax_resize_gather(jnp.asarray(img), (192, 320), scale, (50, 127),
                                       hflip=True)
    got, hw = resize_bilinear_gather(torch.from_numpy(img), (192, 320), scale, (50, 127),
                                     hflip=True)
    assert hw == (int(wh), int(ww))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
