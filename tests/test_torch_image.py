"""The port's device resize and box flip against cim_tpu's, on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cim_tpu.ops.boxes import flip_boxes as jax_flip_boxes
from cim_tpu.ops.image import resize_bilinear_dynamic as jax_resize
from cim_tpu_torch.ops.boxes import flip_boxes
from cim_tpu_torch.ops.image import resize_bilinear_dynamic


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
