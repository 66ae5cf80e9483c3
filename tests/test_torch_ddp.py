"""The port's data-parallel training step on the CPU: two gloo ranks of
tests/torch_ddp_ranks.py, spawned by parallel.launch.

- World size 2 against cim_tpu's Trainer at TPU.DATA_PARALLEL 2 (a
  shard_map over 2 of the 8 virtual CPU devices), from one flax init of
  the tiny body, on make_train_batch(rng, 2, 2) batches (rank r takes row
  r), anti-noise off, 2 steps: metrics within rtol 1e-4 (atol 1e-6),
  parameters within rtol 1e-4 / atol 1e-7 (test_torch_train_step.py's
  bounds: float32 sums in another order, the same mining decisions), and
  the two ranks' parameters bit-equal.
- Both ranks on identical batches against the port at world size 1 run
  with the ranks' thread count (so that the CPU's sums go in their order):
  within rtol 1e-6 (halves of a sum are exact in float32, so the mean of
  two equal gradients is the gradient).
- One gradient reduction a step, whatever GRAD_ACCUM is, and the
  gradients stay views of DDP's buckets from one step to the next.
- Anti-noise seeds: the ranks' differ; world size 1 keeps (seed, step,
  microbatch).
- host_shard_roidb against cim_tpu's; a rank that raises, or stalls past
  the group's timeout, fails launch, whose error holds the traceback of
  every rank that failed.

The ranks' group gets a 60 s timeout (TIMEOUT), 5 s in the stall test.
"""
import os
import time
from datetime import timedelta

import jax
import numpy as np
import pytest
import torch

import cim_tpu.models.tiny  # noqa: F401  (registers tiny.conv_body)
from cim_tpu import parallel as jax_parallel
from cim_tpu.config import clone_cfg, load_cfg
from cim_tpu.data.synthetic import make_microbatch, make_train_batch
from cim_tpu.engine.train import Trainer as JaxTrainer
from cim_tpu_torch import parallel
from cim_tpu_torch.config import load_cfg as torch_load_cfg
from cim_tpu_torch.engine.train import Trainer, derive_seed
from cim_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests import torch_ddp_ranks

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
KW = dict(image_hw=(64, 64), n_props=48, n_valid=40, num_classes=20)
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-7)
SAME_TOL = dict(rtol=1e-6, atol=0)
TIMEOUT = timedelta(seconds=60)


def _tiny(cfg, world):
    cfg = clone_cfg(cfg)
    cfg.MODEL.CONV_BODY = "tiny.conv_body"
    cfg.TPU.PROPOSAL_PAD = 48
    cfg.TPU.GRAD_ACCUM = 2
    cfg.TPU.MAX_CLUSTERS = 8
    cfg.TPU.PRECISION = "f32"
    cfg.TPU.DATA_PARALLEL = world
    cfg.Anti_noise_sampling = False
    return cfg


def _state(trainer, cfg):
    variables = {"params": jax.tree.map(np.asarray, trainer.state.params),
                 "stats": jax.tree.map(np.asarray, trainer.stats)}
    return state_dict_from_jax(variables, conv_body=cfg.MODEL.CONV_BODY,
                               refine_times=cfg.REFINE_TIMES)


@pytest.fixture(scope="module")
def runs():
    path = os.path.join(CONFIG_DIR, "resnet50_voc.yaml")
    jcfg = _tiny(load_cfg(path), 2)
    tcfg = _tiny(torch_load_cfg(path), 2)
    rng = np.random.RandomState(0)
    jt = JaxTrainer(jcfg, jax.random.PRNGKey(0), sample_batch=make_microbatch(rng, **KW))
    assert jt.mesh.devices.size == 2
    init = _state(jt, jcfg)
    batches = [make_train_batch(rng, 2, 2, **KW) for _ in range(2)]
    want = [{k: float(v) for k, v in jt.step(b, jax.random.PRNGKey(s)).items()}
            for s, b in enumerate(batches)]
    ranks = parallel.launch(torch_ddp_ranks.train_scenarios, 2, "cpu",
                            args=(tcfg, init, batches), timeout=TIMEOUT)
    return tcfg, init, batches, want, _state(jt, jcfg), ranks


@pytest.mark.parametrize("step", [0, 1])
def test_world2_metrics_match_jax(runs, step):
    _, _, _, want, _, ranks = runs
    for r in (0, 1):
        got = ranks[r]["rows"]["metrics"][step]
        assert set(got) == set(want[step])
        for key, value in want[step].items():
            np.testing.assert_allclose(got[key], value, err_msg=f"rank {r} {key}", **METRIC_TOL)


def test_world2_params_match_jax_and_each_other(runs):
    _, init, _, _, want, ranks = runs
    assert ranks[0]["world"] == ranks[1]["world"] == 2
    got, other = ranks[0]["rows"]["params"], ranks[1]["rows"]["params"]
    assert set(got) == set(want) == set(other)
    for name, value in want.items():
        assert torch.equal(got[name], other[name]), name
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), err_msg=name, **PARAM_TOL)
        assert torch.equal(got[name], init[name]) == torch.equal(value, init[name]), name


def test_identical_batches_equal_world1(runs):
    cfg, init, batches, _, _, ranks = runs
    single = Trainer(cfg, device="cpu", seed=0)
    single.load_weights(init)
    threads = torch.get_num_threads()
    torch.set_num_threads(ranks[0]["threads"])  # the ranks' CPU sums, in their order
    try:
        want = [single.step({k: v[0] for k, v in b.items()}) for b in batches]
    finally:
        torch.set_num_threads(threads)
    for r in (0, 1):
        for got, w in zip(ranks[r]["same"]["metrics"], want):
            for key, value in w.items():
                np.testing.assert_allclose(got[key], value, err_msg=key, **SAME_TOL)
        for name, value in single.model.state_dict().items():
            np.testing.assert_allclose(ranks[r]["same"]["params"][name].numpy(), value.numpy(),
                                       err_msg=name, **SAME_TOL)


def test_one_reduction_a_step_whatever_the_accumulation(runs):
    passes = runs[5][0]["passes"]
    assert passes[1]["last"] == passes[2]["last"] == 2  # 2 steps
    assert passes[1]["buckets"] == passes[2]["buckets"]


def test_gradients_stay_bucket_views(runs):
    """Zeroed in place, the gradients accumulate in DDP's buckets: no
    gradient is allocated anew in a step and copied into its bucket."""
    assert runs[5][0]["bucket_views"] and runs[5][1]["bucket_views"]


def test_anti_noise_seeds_per_rank(runs):
    cfg, *_ = runs
    seeds = [runs[5][r]["seeds"] for r in (0, 1)]
    assert seeds[0] != seeds[1]
    assert seeds[0] == [derive_seed(0, 2, i, 0) for i in range(2)]  # after 2 steps
    single = Trainer(cfg, device="cpu", seed=7)
    assert single.ddp is None and single.world == 1
    assert [single.mining_seed(i) for i in range(3)] == [derive_seed(7, 0, i) for i in range(3)]


def test_host_shard_roidb_matches_jax():
    roidb = [{"id": i} for i in range(11)]
    shards = [parallel.host_shard_roidb(roidb, r, 3) for r in range(3)]
    for r, shard in enumerate(shards):
        assert shard == jax_parallel.host_shard_roidb(roidb, r, 3)
    ids = sorted(e["id"] for s in shards for e in s)
    assert ids == list(range(11)) and sum(len(s) for s in shards) == 11


def test_a_failing_rank_fails_the_launch():
    """The launch raises rank 1's error and ends rank 0 without waiting
    for it."""
    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 1 fails"):
        parallel.launch(torch_ddp_ranks.fail_on_rank1, 2, "cpu", timeout=TIMEOUT)
    assert time.monotonic() - t0 < 60


def test_every_failing_rank_is_named_in_the_launch_error():
    """Each rank that fails after joining the group writes its traceback,
    and the launcher's error holds both under their ranks, not only the
    first that the spawn reports."""
    with pytest.raises(RuntimeError) as info:
        parallel.launch(torch_ddp_ranks.fail_on_both_ranks, 2, "cpu", timeout=TIMEOUT)
    msg = str(info.value)
    for r in (0, 1):
        assert f"--- rank {r} ---" in msg and f"rank {r} fails after init" in msg


def test_a_stalled_rank_fails_the_launch_at_the_timeout():
    """Rank 0's all-reduce gives up after the group's timeout, and its
    error ends the sleeping rank 1."""
    t0 = time.monotonic()
    with pytest.raises(Exception, match="(?i)timed out|timeout"):
        parallel.launch(torch_ddp_ranks.stall_on_rank1, 2, "cpu", timeout=timedelta(seconds=5))
    assert time.monotonic() - t0 < 60


def test_launch_ranks_and_devices(monkeypatch):
    """Two spawned gloo ranks on the CPU, the host's cores split between
    them; a world of one runs here, without a group; torchrun's WORLD_SIZE
    must be the run's."""
    got = parallel.launch(torch_ddp_ranks.rank_and_device, 2, "cpu", timeout=TIMEOUT)
    threads = max(1, (os.cpu_count() or 1) // 2)
    assert got == {0: (0, 2, "cpu", threads), 1: (1, 2, "cpu", threads)}
    assert parallel.launch(torch_ddp_ranks.rank_and_device, 1, "cpu")[0][:3] == (0, 1, "cpu")
    assert parallel.rank_device("cuda", 3) == torch.device("cuda", 3)
    assert parallel.rank_device("cuda:0", 3) == torch.device("cuda", 0)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="torchrun started 4"):
        parallel.launch(torch_ddp_ranks.rank_and_device, 2, "cpu")
