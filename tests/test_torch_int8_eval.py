"""The port's dynamic int8 eval head (TPU.EVAL_INT8, ops/quant.py)
against cim_tpu's, on the CPU.

- int8_dense and int8_conv_nhwc on the same float32 inputs as cim_tpu's
  (jitted, as its model runs them): the int32 accumulators equal bit for
  bit (cim_tpu's from its own scale and quantization functions), the
  outputs without a bias too, and with one within 1 ulp of |x w| + |b|
  (XLA on the CPU fuses the dequantizing product and the bias add into one
  multiply-add, rounded once).
- Pad-row invariance: a valid row's output does not move, to the bit,
  whatever rides in the pad rows (per-row and per-sample scales).
- torch._int_mm's shape rules (more than 16 rows, inner and output sizes
  multiples of 8) raise, on the CPU as on the card.
- An EVAL_INT8 Evaluator (tiny body, float32, one pass) against cim_tpu's
  EVAL_INT8 Evaluator on the same weights: within rtol 2e-3, atol 2e-5
  (the port's cross-package bound); and within cim_tpu's own bound of the
  float scores (tests/test_int8_eval.py: max < 0.05).
- The switch: the Evaluator runs an int8 view that shares the caller's
  parameters and leaves the caller's model (a Trainer's) in float;
  BatchedEvaluator's replicas carry it, and a stack's int8 scores equal
  each image's own (rtol 1e-5, atol 1e-7).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cim_tpu.models.tiny  # noqa: F401  (registers tiny.conv_body)
from cim_tpu.config import clone_cfg, load_cfg
from cim_tpu.engine import test as jax_test
from cim_tpu.models.builder import build_model as build_jax_model
from cim_tpu.ops import quant as jax_quant
from cim_tpu_torch.engine import test as torch_test
from cim_tpu_torch.ops import quant
from tests.torch_parity import CONFIG_DIR, init_variables, random_rois, torch_model
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

CROSS_TOL = dict(rtol=2e-3, atol=2e-5)
SELF_TOL = dict(rtol=1e-5, atol=1e-7)


@jax.jit
def _jax_dense_acc(x, kernel):
    """cim_tpu int8_dense's accumulators, by its own functions."""
    sx = jnp.maximum(jnp.max(jnp.abs(x), axis=-1, keepdims=True) / 127.0, 1e-12)
    sw = jax_quant._weight_scales(kernel, reduce_axes=(0,))
    return jax.lax.dot_general(jax_quant._quant(x, sx), jax_quant._quant(kernel, sw),
                               (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)


@jax.jit
def _jax_conv_acc(x, kernel):
    """cim_tpu int8_conv_nhwc's accumulators, by its own functions."""
    sx = jnp.maximum(jnp.max(jnp.abs(x), axis=(1, 2, 3), keepdims=True) / 127.0, 1e-12)
    sw = jax_quant._weight_scales(kernel, reduce_axes=(0, 1, 2))
    return jax.lax.conv_general_dilated(
        jax_quant._quant(x, sx), jax_quant._quant(kernel, sw), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)


def _check_outputs(jax_fn, fn, x, kernel, weight, bias):
    bare = np.asarray(jax.jit(jax_fn)(x, kernel))
    np.testing.assert_array_equal(fn(torch.from_numpy(x), weight).numpy(), bare)
    want = np.asarray(jax.jit(jax_fn)(x, kernel, bias))
    got = fn(torch.from_numpy(x), weight, torch.from_numpy(bias)).numpy()
    assert (np.abs(got - want) <= np.spacing(np.abs(bare) + np.abs(bias))).all()


def test_int8_dense_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(40, 512).astype(np.float32)
    kernel = (rng.randn(512, 64) * 0.05).astype(np.float32)  # cim_tpu's (K, F)
    bias = rng.randn(64).astype(np.float32)
    weight = torch.from_numpy(np.ascontiguousarray(kernel.T))  # nn.Linear's (F, K)
    acc, _, _ = quant.dense_accumulators(torch.from_numpy(x), weight)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(_jax_dense_acc(x, kernel)))
    _check_outputs(jax_quant.int8_dense, quant.int8_dense, x, kernel, weight, bias)


def test_int8_conv_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(20, 7, 7, 64).astype(np.float32)
    kernel = (rng.randn(3, 3, 64, 32) * 0.05).astype(np.float32)  # HWIO
    bias = rng.randn(32).astype(np.float32)
    weight = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))  # OIHW
    acc, _, _ = quant.conv_accumulators(torch.from_numpy(x), weight)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(_jax_conv_acc(x, kernel)))
    _check_outputs(jax_quant.int8_conv_nhwc, quant.int8_conv_nhwc, x, kernel, weight, bias)


def test_pad_rows_move_no_valid_row():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(20, 7, 7, 16).astype(np.float32))
    pad = torch.from_numpy(rng.randn(12, 7, 7, 16).astype(np.float32) * 1e3)
    w = torch.from_numpy((rng.randn(8, 16, 3, 3) * 0.1).astype(np.float32))
    b = torch.from_numpy(rng.randn(8).astype(np.float32))
    small = quant.int8_conv_nhwc(x, w, b)
    padded = quant.int8_conv_nhwc(torch.cat([x, pad]), w, b)
    assert torch.equal(small, padded[:20])
    xd = x.reshape(20, -1)[:, :64]
    wd = torch.from_numpy((rng.randn(8, 64) * 0.1).astype(np.float32))
    small = quant.int8_dense(xd, wd)
    padded = quant.int8_dense(torch.cat([xd, pad.reshape(12, -1)[:, :64]]), wd)
    assert torch.equal(small, padded[:20])


@pytest.mark.parametrize("m,k,n", [(16, 64, 8), (32, 60, 8), (32, 64, 12)])
def test_int_mm_shape_rules_raise(m, k, n):
    with pytest.raises(ValueError, match="shape rules"):
        quant.int8_dense(torch.ones(m, k), torch.ones(n, k))


def _cfg():
    cfg = clone_cfg(load_cfg(os.path.join(CONFIG_DIR, "resnet50_voc.yaml")))
    cfg.MODEL.CONV_BODY = "tiny.conv_body"
    cfg.TPU.PRECISION = "f32"
    cfg.FAST_RCNN.MLP_HEAD_DIM = 64
    cfg.TEST.SCALE = 64
    cfg.TEST.BBOX_AUG.ENABLED = False
    return cfg


def _image(rng, h=64, w=80, n=24):
    im = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    return im, random_rois(rng, n, h, w, min_size=8.0), (rng.rand(n, 7, 7) > 0.5).astype(
        np.float32)


@pytest.fixture(scope="module")
def tiny():
    cfg = _cfg()
    variables = init_variables(cfg, seed=6)
    return cfg, variables, torch_model(cfg, variables)


def test_int8_evaluator_matches_jax(tiny):
    cfg, variables, model = tiny
    cfg8 = clone_cfg(cfg)
    cfg8.TPU.EVAL_INT8 = True
    im, boxes, masks = _image(np.random.RandomState(6))
    jax_model = build_jax_model(cfg)
    want, _ = jax_test.Evaluator(cfg8, jax_model, variables).im_detect_all(im, boxes, masks)
    calls = quant.int_mm.calls
    got, _ = torch_test.Evaluator(cfg8, model, device="cpu").im_detect_all(im, boxes, masks)
    assert quant.int_mm.calls - calls == 9 + 1  # the conv's taps, seg_fc.0
    np.testing.assert_allclose(got, want, **CROSS_TOL)
    f32, _ = torch_test.Evaluator(cfg, model, device="cpu").im_detect_all(im, boxes, masks)
    assert 0 < np.abs(got - f32).max() < 0.05


def test_int8_view_leaves_the_trainer_float(tiny):
    from cim_tpu_torch.engine.train import Trainer

    cfg, _, _ = tiny
    cfg8 = clone_cfg(cfg)
    cfg8.TPU.EVAL_INT8 = True
    cfg8.TPU.DATA_PARALLEL = 1
    trainer = Trainer(cfg8, device="cpu", seed=0)
    assert trainer.model.Box_Head.int8_eval is False
    ev = torch_test.Evaluator(cfg8, trainer.model, device="cpu")
    assert ev.model.Box_Head.int8_eval is True
    assert trainer.model.Box_Head.int8_eval is False
    assert ev.model.Box_Head.mask_branch is trainer.model.Box_Head.mask_branch
    assert dict(ev.model.named_parameters()).keys() == dict(trainer.model.named_parameters()).keys()
    for (_, p), (_, q) in zip(ev.model.named_parameters(), trainer.model.named_parameters()):
        assert p is q


def test_int8_batched_replicas_and_stacks(tiny):
    cfg, _, model = tiny
    cfg8 = clone_cfg(cfg)
    cfg8.TPU.EVAL_INT8 = True
    rng = np.random.RandomState(7)
    items = [_image(rng, n=20 + i) for i in range(3)]
    batched = torch_test.BatchedEvaluator(cfg8, model, 2, devices=["cpu", "cpu"])
    assert all(r.model.Box_Head.int8_eval for r in batched._replicas)
    single = torch_test.Evaluator(cfg8, model, device="cpu")
    for (gs, _), it in zip(batched.im_detect_all_many(items), items):
        np.testing.assert_allclose(gs, single.im_detect_all(*it)[0], **SELF_TOL)
    assert model.Box_Head.int8_eval is False
