"""The port's stability run (cim_tpu_torch/tools/stability_run.py) against
cim_tpu's Trainer, on the CPU.

Its loop (run_steps over a pool of 2 batches staged on the device, 3
steps) drives the port's Trainer of the tiny body in float32 with
anti-noise sampling off, beside cim_tpu.engine.train.Trainer on the same
pool, from one flax init (the port loads it through state_dict_from_jax).
Both take the XLA RoIAlign's grid cap (TPU.PALLAS_ROI_ALIGN off: the CPU
runs no kernel). Every loss must agree within rtol 1e-4, atol 1e-6, the
bound of test_torch_train_step.py. Then main() on the CPU: a summary of
finite losses, and each of the run's two failures raises.
"""
import jax
import numpy as np
import pytest

import cim_tpu.models.tiny  # noqa: F401  (registers tiny.conv_body)
from cim_tpu.config import clone_cfg, load_cfg as jax_load_cfg
from cim_tpu.data.synthetic import make_microbatch, make_train_batch
from cim_tpu.engine.train import Trainer as JaxTrainer
from cim_tpu_torch.engine.train import Trainer
from cim_tpu_torch.tools import stability_run
from cim_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

KW = dict(image_hw=(64, 64), n_props=48, n_valid=40, num_classes=20)
TINY = ["MODEL.CONV_BODY", "tiny.conv_body", "TPU.PROPOSAL_PAD", "48",
        "TPU.MAX_CLUSTERS", "8", "Anti_noise_sampling", "False"]
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
STEPS = 3


def _tiny(cfg):
    cfg.MODEL.CONV_BODY = "tiny.conv_body"
    cfg.TPU.PROPOSAL_PAD = 48
    cfg.TPU.MAX_CLUSTERS = 8
    cfg.TPU.PRECISION = "f32"
    cfg.TPU.DATA_PARALLEL = 1
    cfg.TPU.PALLAS_ROI_ALIGN = False
    cfg.Anti_noise_sampling = False
    return cfg


@pytest.fixture(scope="module")
def histories():
    args = stability_run.parse_args(["--device", "cpu", "--precision", "f32", "--set", *TINY])
    tcfg = stability_run.configure(args)
    tcfg.TPU.PALLAS_ROI_ALIGN = False
    jcfg = _tiny(clone_cfg(jax_load_cfg(args.cfg)))
    accum = tcfg.TPU.GRAD_ACCUM
    assert accum == jcfg.TPU.GRAD_ACCUM == 4
    rng = np.random.RandomState(0)
    jt = JaxTrainer(jcfg, jax.random.PRNGKey(0), sample_batch=make_microbatch(rng, **KW))
    variables = {"params": jax.tree.map(np.asarray, jt.state.params),
                 "stats": jax.tree.map(np.asarray, jt.stats)}
    tt = Trainer(tcfg, device="cpu", seed=0)
    tt.load_weights(state_dict_from_jax(variables, conv_body=tcfg.MODEL.CONV_BODY,
                                        refine_times=tcfg.REFINE_TIMES))
    pool = [make_train_batch(rng, 1, accum, **KW) for _ in range(2)]

    staged = [stability_run.to_device({k: v[0] for k, v in b.items()}, tt.device) for b in pool]
    got, secs = stability_run.run_steps(tt, lambda i: staged[i % 2], STEPS, log=lambda s: None)
    want = []
    for i in range(STEPS):
        m = jt.step(pool[i % 2], jax.random.PRNGKey(100 + i))
        want.append({k: float(v) for k, v in m.items() if k.endswith("loss")})
    return got, want, secs


@pytest.mark.parametrize("step", range(STEPS))
def test_losses_match_cim_tpu_trainer(histories, step):
    got, want, _ = histories
    assert set(got[step]) == set(want[step])
    for key, value in want[step].items():
        np.testing.assert_allclose(got[step][key], value, err_msg=key, **LOSS_TOL)
    assert len(histories[2]) == STEPS and min(histories[2]) > 0


def _main(*extra, steps=3):
    return stability_run.main(["--device", "cpu", "--steps", str(steps), "--image_hw", "64", "64",
                               "--n_props", "40", "--precision", "f32", "--batch_pool", "2",
                               "--set", *TINY, "FAST_RCNN.MLP_HEAD_DIM", "256", *extra])


def test_main_summary_on_the_cpu():
    s = _main()
    assert s["device"] == "cpu" and s["steps"] == 3 and len(s["history"]) == 3
    assert s["proposal_pad"] == 48 and s["grad_accum"] == 4
    assert np.isfinite([h["total_loss"] for h in s["history"]]).all()
    assert s["first_total_loss"] == s["history"][0]["total_loss"]
    assert s["s_per_step_steady"] > 0 and s["peak_device_gb"] is None


def test_main_raises_on_a_non_finite_loss():
    # an LR of 1e30 blows the weights up in the first update
    with pytest.raises(FloatingPointError, match="step 1: non-finite total_loss"):
        _main("SOLVER.BASE_LR", "1e30")


def test_main_raises_when_the_loss_does_not_fall_in_40_steps():
    # LR 0 and one pooled batch without anti-noise draws: every step's loss is the first's
    with pytest.raises(AssertionError, match="did not decrease"):
        stability_run.main(["--device", "cpu", "--steps", "40", "--image_hw", "64", "64",
                            "--n_props", "40", "--precision", "f32", "--batch_pool", "1",
                            "--set", *TINY, "FAST_RCNN.MLP_HEAD_DIM", "256",
                            "TPU.GRAD_ACCUM", "1", "SOLVER.BASE_LR", "0.0"])
