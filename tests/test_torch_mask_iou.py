"""The port's mask IoU (cim_tpu_torch.ops.mask_iou) against cim_tpu's
(cim_tpu.ops.mask_iou) on the same 0/1 masks, made with numpy from a seed:
bit-equal float32 matrices, with empty masks (0 where the divisor is 0),
bool and 0/1 float inputs, and the one-product pair of create_cob_iou
equal to the two single functions; the float16 rounding equal to numpy's.
On a card (marked cuda): the card's matrices are the CPU's, bit for bit.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cim_tpu_torch.ops import mask_iou as tiou

jiou = importlib.import_module("cim_tpu.ops.mask_iou")  # cim_tpu.ops re-exports the function


def _masks(seed, n, h, w, empty=()):
    rng = np.random.RandomState(seed)
    m = rng.rand(n, h, w) < rng.uniform(0.05, 0.7, (n, 1, 1))
    for i in empty:
        m[i] = False
    return m


@pytest.mark.parametrize("case", ["square", "rect_empty", "float_input"])
@pytest.mark.parametrize("fn", ["mask_iou", "mask_asymmetric_iou"])
def test_matches_cim_tpu_bit_for_bit(fn, case):
    a = _masks(1, 14, 9, 11, empty=(3,) if case == "rect_empty" else ())
    b = a if case == "square" else _masks(2, 6, 9, 11, empty=(0, 5) if case == "rect_empty" else ())
    want = np.asarray(getattr(jiou, fn)(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if case == "float_input":
        ta, tb = ta.float(), tb.float()
    got = getattr(tiou, fn)(ta, tb).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if case == "rect_empty":
        assert (got[:, 0] == 0).all() and (got[:, 5] == 0).all()


def test_pair_equals_the_single_functions_and_rounds_as_numpy():
    """The one-product pair at a COB-like size (many small and large masks
    of one image) and its float16 rounding, as cim_tpu's CLI stores it."""
    m = _masks(3, 40, 30, 37, empty=(7,))
    iou, asy = tiou.mask_iou_matrices(torch.from_numpy(m))
    want_iou = np.asarray(jiou.mask_iou(jnp.asarray(m), jnp.asarray(m)))
    want_asy = np.asarray(jiou.mask_asymmetric_iou(jnp.asarray(m), jnp.asarray(m)))
    np.testing.assert_array_equal(iou.numpy(), want_iou)
    np.testing.assert_array_equal(asy.numpy(), want_asy)
    np.testing.assert_array_equal(iou.half().numpy().view(np.uint16),
                                  want_iou.astype(np.float16).view(np.uint16))
    np.testing.assert_array_equal(asy.half().numpy().view(np.uint16),
                                  want_asy.astype(np.float16).view(np.uint16))
    assert iou[7].sum() == 0 and asy[:, 7].sum() == 0
    np.testing.assert_array_equal(np.diag(iou.numpy())[np.arange(40) != 7], 1.0)


@pytest.mark.cuda
def test_card_matrices_are_the_cpus():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    m = torch.from_numpy(_masks(5, 300, 75, 100, empty=(9,)))
    for got, want in zip(tiou.mask_iou_matrices(m.cuda()), tiou.mask_iou_matrices(m)):
        assert torch.equal(got.cpu(), want)
