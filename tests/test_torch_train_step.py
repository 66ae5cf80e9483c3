"""The port's training step against cim_tpu's, on the CPU in float32.

Both trainers start from one flax init of the tiny body (cim_tpu's
Trainer initialises it; the port loads it through state_dict_from_jax),
with tests/test_train_step.py's config: PROPOSAL_PAD 48, GRAD_ACCUM 2,
MAX_CLUSTERS 8, float32, and anti-noise sampling off, so that the step
draws no random numbers. Two steps on seeded synthetic batches must give
every loss metric within rtol 1e-4 and all parameters within rtol 1e-4
(atol 1e-7): float32 sums in another order, and mining decisions that
agree exactly.
"""
import os

import jax
import numpy as np
import pytest
import torch

import cim_tpu.models.tiny  # noqa: F401  (registers tiny.conv_body)
from cim_tpu.config import clone_cfg, load_cfg
from cim_tpu.data.synthetic import make_microbatch, make_train_batch
from cim_tpu.engine.train import Trainer as JaxTrainer
from cim_tpu_torch.config import load_cfg as torch_load_cfg
from cim_tpu_torch.engine.checkpoint import latest_step, load_ckpt, save_ckpt
from cim_tpu_torch.engine.train import Trainer, derive_seed
from cim_tpu_torch.utils.jax_weights import state_dict_from_jax

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
KW = dict(image_hw=(64, 64), n_props=48, n_valid=40, num_classes=20)
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-7)


def _tiny(cfg):
    cfg = clone_cfg(cfg)
    cfg.MODEL.CONV_BODY = "tiny.conv_body"
    cfg.TPU.PROPOSAL_PAD = 48
    cfg.TPU.GRAD_ACCUM = 2
    cfg.TPU.MAX_CLUSTERS = 8
    cfg.TPU.PRECISION = "f32"
    cfg.TPU.DATA_PARALLEL = 1
    cfg.Anti_noise_sampling = False
    return cfg


def _variables(trainer):
    return {"params": jax.tree.map(np.asarray, trainer.state.params),
            "stats": jax.tree.map(np.asarray, trainer.stats)}


def _state(variables, cfg):
    return state_dict_from_jax(variables, conv_body=cfg.MODEL.CONV_BODY,
                               refine_times=cfg.REFINE_TIMES)


@pytest.fixture(scope="module")
def runs():
    path = os.path.join(CONFIG_DIR, "resnet50_voc.yaml")
    jcfg = _tiny(load_cfg(path))
    tcfg = _tiny(torch_load_cfg(path))
    rng = np.random.RandomState(0)
    jt = JaxTrainer(jcfg, jax.random.PRNGKey(0), sample_batch=make_microbatch(rng, **KW))
    init = _state(_variables(jt), jcfg)
    tt = Trainer(tcfg, device="cpu", seed=0)
    tt.load_weights(init)
    batches = [make_train_batch(rng, 1, 2, **KW) for _ in range(2)]
    steps = []
    for s, batch in enumerate(batches):
        want = {k: float(v) for k, v in jt.step(batch, jax.random.PRNGKey(s)).items()}
        got = tt.step({k: v[0] for k, v in batch.items()})
        steps.append((want, got))
    return tcfg, init, batches, steps, _state(_variables(jt), jcfg), tt


@pytest.mark.parametrize("step", [0, 1])
def test_step_metrics_match_jax(runs, step):
    want, got = runs[3][step]
    assert set(got) == set(want)
    assert np.isfinite(list(got.values())).all() and got["total_loss"] > 0
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, err_msg=key, **METRIC_TOL)


def test_params_after_two_steps_match_jax(runs):
    cfg, init, _, _, want, trainer = runs
    got = trainer.model.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), err_msg=name,
                                   **PARAM_TOL)
        # the tiny body has no frozen stage: what moved in cim_tpu moved here
        assert torch.equal(got[name], init[name]) == torch.equal(value, init[name]), name
    assert sum(not torch.equal(got[n], init[n]) for n in want) >= len(want) - 1


def test_checkpoint_resume_continues_the_run(runs, tmp_path):
    """Save after one step, load into a fresh trainer, run step two: the
    same metrics and parameters as the uninterrupted trainer."""
    cfg, init, batches, steps, _, trainer = runs
    first = Trainer(cfg, device="cpu", seed=0)
    first.load_weights(init)
    first.step({k: v[0] for k, v in batches[0].items()})
    save_ckpt(str(tmp_path), first)
    assert latest_step(str(tmp_path)) == 1

    resumed = Trainer(cfg, device="cpu", seed=5)
    load_ckpt(str(tmp_path), resumed)
    assert resumed.step_count == 1 and resumed.seed == 0
    got = resumed.step({k: v[0] for k, v in batches[1].items()})
    assert got == steps[1][1]
    for name, value in trainer.model.state_dict().items():
        torch.testing.assert_close(resumed.model.state_dict()[name], value, rtol=0, atol=0)


def test_frozen_stages_and_bias_group():
    """resnet50's FREEZE_AT 2 stages get requires_grad False and stay out
    of the optimizer; every leaf named bias is in the 2x-LR group."""
    cfg = torch_load_cfg(os.path.join(CONFIG_DIR, "resnet50_voc.yaml"))
    cfg.FAST_RCNN.MLP_HEAD_DIM = 16
    trainer = Trainer(cfg, device="cpu")
    names = [n for n, _ in trainer.optimizer.params]
    for name, p in trainer.model.named_parameters():
        frozen = name.startswith(("Conv_Body.res1.", "Conv_Body.res2."))
        assert p.requires_grad != frozen, name
        assert (name in names) != frozen, name
    assert trainer.optimizer._group("Conv_Body.res3.0.bn1.bias") == (0.0, 2.0)
    assert trainer.optimizer._group("Box_Head.seg_fc.0.weight") == (0.0005, 1.0)


def test_derive_seed_separates_steps_microbatches_and_branches():
    seeds = {derive_seed(0, s, m, k) for s in range(3) for m in range(4) for k in range(3)}
    assert len(seeds) == 36 and all(0 <= s < 2**63 for s in seeds)


def test_trainer_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    cfg = _tiny(torch_load_cfg(os.path.join(CONFIG_DIR, "resnet50_voc.yaml")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg)
