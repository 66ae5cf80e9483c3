"""The port's LR schedule and optimizers against cim_tpu's, on the CPU.

lr_schedule at tests/test_train_step.py's step points (and under constant
warmup) must equal cim_tpu's float32 value. SGD (with the momentum
correction) and Adam run five steps of seeded gradients across a warmup
end and an LR decay, on parameters named as the model names them, against
cim_tpu's make_sgd / make_adam on the same values: parameters within
rtol 1e-6 (atol 1e-9; float32 updates in another order); frozen stages
never move; a bias leaf steps at twice the LR without weight decay.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cim_tpu.config import load_cfg
from cim_tpu.engine.optimizer import build_masks, lr_schedule as jax_lr_schedule, make_adam, make_sgd
from cim_tpu_torch.config import load_cfg as torch_load_cfg
from cim_tpu_torch.engine.optimizer import SGD, Adam, lr_schedule, make_optimizer

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "resnet50_voc.yaml")
TOL = dict(rtol=1e-6, atol=1e-9)
# flax path -> the port's parameter name; res1 / res2 are FREEZE_AT 2 stages
NAMES = {
    ("conv_body", "res1_conv", "conv", "kernel"): "Conv_Body.res1.0.weight",
    ("conv_body", "res2", "block0", "bn1", "bias"): "Conv_Body.res2.0.bn1.bias",
    ("conv_body", "res4", "block0", "conv1", "conv", "kernel"): "Conv_Body.res4.0.conv1.weight",
    ("conv_body", "res4", "block0", "bn1", "scale"): "Conv_Body.res4.0.bn1.weight",
    ("conv_body", "res4", "block0", "bn1", "bias"): "Conv_Body.res4.0.bn1.bias",
    ("cls_iou", "classifier", "dense", "kernel"): "cls_iou_model.classifier.weight",
    ("cls_iou", "classifier", "dense", "bias"): "cls_iou_model.classifier.bias",
}
FROZEN = ("Conv_Body.res1.", "Conv_Body.res2.")


def _cfgs(solver="SGD"):
    out = []
    for loader in (load_cfg, torch_load_cfg):
        cfg = loader(CONFIG)
        cfg.SOLVER.TYPE = solver
        cfg.SOLVER.BASE_LR = 0.01
        cfg.SOLVER.WARM_UP_ITERS = 2
        cfg.SOLVER.STEPS = (0, 3)
        out.append(cfg)
    return out


@pytest.mark.parametrize("method", ["linear", "constant"])
def test_lr_schedule_matches_jax(method):
    jcfg, tcfg = (load_cfg(CONFIG), torch_load_cfg(CONFIG))
    for cfg in (jcfg, tcfg):
        cfg.SOLVER.WARM_UP_METHOD = method
    for step in (0, 1, 250, 499, 500, 59999, 60000, 89999):
        want = float(np.float32(jax_lr_schedule(jcfg, step)))
        assert lr_schedule(tcfg, step) == want, step
    base = tcfg.SOLVER.BASE_LR
    if method == "linear":
        np.testing.assert_allclose(lr_schedule(tcfg, 250), base * (1 / 3 * 0.5 + 0.5), rtol=1e-6)
    np.testing.assert_allclose(lr_schedule(tcfg, 60000), base * 0.1, rtol=1e-6)


def _tree(flat):
    tree = {}
    for path, value in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = jnp.asarray(value)
    return tree


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@pytest.mark.parametrize("solver", ["SGD", "Adam"])
def test_updates_match_jax_across_decay(solver):
    jcfg, tcfg = _cfgs(solver)
    rng = np.random.RandomState(0)
    init = {path: rng.randn(3, 2).astype(np.float32) for path in NAMES}
    params = _tree(init)
    trainable, bias = build_masks(params, ["res1", "res2"])
    opt_init, opt_update = (make_sgd if solver == "SGD" else make_adam)(jcfg, trainable, bias)
    state = opt_init(params)

    tparams = {NAMES[p]: torch.from_numpy(v.copy()) for p, v in init.items()}
    for name, p in tparams.items():
        p.requires_grad_(not name.startswith(FROZEN))
    opt = make_optimizer(tcfg, [(n, p) for n, p in tparams.items() if p.requires_grad])
    assert isinstance(opt, SGD if solver == "SGD" else Adam)

    for step in range(5):  # warmup ends at 2, the LR decays at 3
        grads = {path: rng.randn(3, 2).astype(np.float32) for path in NAMES}
        lr = lr_schedule(tcfg, step)
        assert lr == float(np.float32(jax_lr_schedule(jcfg, step)))
        params, state = opt_update(_tree(grads), state, params, jax_lr_schedule(jcfg, step))
        for path, name in NAMES.items():
            tparams[name].grad = torch.from_numpy(grads[path])
        opt.step(lr)
        for path, name in NAMES.items():
            np.testing.assert_allclose(tparams[name].detach().numpy(), _leaf(params, path),
                                       err_msg=f"{name} at step {step}", **TOL)
    for path, name in NAMES.items():
        moved = not np.array_equal(tparams[name].detach().numpy(), init[path])
        assert moved != name.startswith(FROZEN), name


def test_sgd_bias_steps_twice_the_lr_without_decay():
    _, cfg = _cfgs("SGD")
    w = torch.ones(3, requires_grad=True)
    b = torch.ones(3, requires_grad=True)
    opt = SGD(cfg, [("head.weight", w), ("head.bias", b)])
    w.grad = torch.full((3,), 0.5)
    b.grad = torch.full((3,), 0.5)
    opt.step(0.1)
    wd = cfg.SOLVER.WEIGHT_DECAY
    torch.testing.assert_close(w.detach(), torch.full((3,), 1 - 0.1 * (0.5 + wd)))
    torch.testing.assert_close(b.detach(), torch.full((3,), 1 - 0.2 * 0.5))


def test_momentum_correction_only_at_a_change():
    _, cfg = _cfgs("SGD")
    opt = SGD(cfg, [])
    assert opt.correction(0.01) == 1.0  # first step: prev_lr is 0
    opt.prev_lr = 0.01
    assert opt.correction(0.01) == 1.0
    np.testing.assert_allclose(opt.correction(0.001), 0.1, rtol=1e-6)


def test_state_dict_round_trip():
    _, cfg = _cfgs("Adam")
    p = torch.ones(2, requires_grad=True)
    opt = Adam(cfg, [("x.weight", p)])
    p.grad = torch.ones(2)
    opt.step(0.01)
    state = opt.state_dict()
    other = Adam(cfg, [("x.weight", torch.ones(2, requires_grad=True))])
    other.load_state_dict(state)
    assert other.count == 1 and other.prev_lr == opt.prev_lr
    torch.testing.assert_close(other.mu[0], opt.mu[0])
    torch.testing.assert_close(other.nu[0], opt.nu[0])
