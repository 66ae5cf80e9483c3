"""The port's CIM mining against cim_tpu's, on the CPU.

Same seeded inputs through cim_tpu.mining.cim (and cim_tpu.ops.nms) and
their counterparts in cim_tpu_torch. Integer and bool outputs (keep masks,
mined rows, labels, big-proposal flags) must agree exactly; float outputs
(mined weights, loss weights) are products of the same float32 scores and
must agree within rtol 1e-6. Inputs include padding rows, class budgets,
class-agnostic detector scores and scores quantized to a few levels, so
that the stable-sort, first-max and scatter-max tie rules are exercised.
Anti-noise sampling takes cim_tpu's own jax.random draws as injected
uniforms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cim_tpu.mining import cim as jcim
from cim_tpu.ops.nms import greedy_nms_from_iou as jax_nms
from cim_tpu_torch.mining import cim as tcim
from cim_tpu_torch.ops.nms import greedy_nms_from_iou

FLOAT_TOL = dict(rtol=1e-6, atol=0)


def _instance(rng, n=60, pad=8, c=20, n_labels=3, agnostic=False, quantize=False):
    """Realistic CIM inputs padded by ``pad`` rows: softmax-like scores and
    consistent IoU / containment matrices from random masks."""
    masks = rng.rand(n, 14, 14) > rng.uniform(0.4, 0.7)
    flat = masks.reshape(n, -1).astype(np.float64)
    inter = flat @ flat.T
    area = flat.sum(-1)
    iou = (inter / np.maximum(area[:, None] + area[None, :] - inter, 1)).astype(np.float32)
    asy = (inter / np.maximum(area[None, :], 1)).astype(np.float32)
    cls = rng.dirichlet(np.ones(c), size=n).astype(np.float32)
    if agnostic:
        det = rng.rand(n, 1).astype(np.float32)
        det /= det.sum()
    else:
        det = rng.dirichlet(np.ones(n), size=c).T.astype(np.float32).copy()
    if quantize:  # many exact ties in the scores
        cls = np.round(cls * 8) / 8
        det = np.round(det * 64) / 64
    labels = np.zeros(c, np.float32)
    labels[rng.choice(c, n_labels, replace=False)] = 1

    def rows(x):
        return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])

    def square(m):
        out = np.zeros((n + pad, n + pad), np.float32)
        out[:n, :n] = m
        return out

    valid = np.arange(n + pad) < n
    return rows(cls), rows(det), labels, square(iou), square(asy), valid


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _assert_mined(got, want):
    np.testing.assert_array_equal(got.gt_mask.numpy(), np.asarray(want.gt_mask))
    np.testing.assert_array_equal(got.asy_iou_flag.numpy(), np.asarray(want.asy_iou_flag))
    np.testing.assert_array_equal(got.gt_labels.numpy(), np.asarray(want.gt_labels))
    np.testing.assert_allclose(got.gt_weights.numpy(), np.asarray(want.gt_weights), **FLOAT_TOL)


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "ties"])
def test_greedy_nms_from_iou_matches_jax(quantize):
    """Five batched classes of 30 candidates, a third of them padding."""
    rng = np.random.RandomState(1)
    c, n = 5, 30
    iou = rng.rand(c, n, n).astype(np.float32)
    iou = (iou + iou.transpose(0, 2, 1)) / 2
    scores = rng.rand(c, n).astype(np.float32)
    if quantize:
        scores = np.round(scores * 4) / 4
    valid = rng.rand(c, n) > 0.3
    want = jax.vmap(lambda i, s, v: jax_nms(i, s, 0.5, valid=v))(*_j(iou, scores, valid))
    launches = greedy_nms_from_iou.kernel_launches
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = greedy_nms_from_iou(*_t(iou, scores), 0.5, valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert greedy_nms_from_iou.kernel_launches == launches  # CPU tensors: the plain loop
    # a host sync (cim.sync span) a round, at least one, and one for the
    # test that ends the loop; a round decides at least one candidate
    syncs = sum(e.name == "cim.sync" for e in prof.events())
    assert 2 <= syncs <= valid.any(0).sum() + 1
    assert not (got.numpy() & ~valid).any()


@pytest.mark.parametrize("budget", [0, 4])
@pytest.mark.parametrize("agnostic", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_cim_mine_matches_jax(seed, agnostic, budget):
    rng = np.random.RandomState(seed)
    cls, det, labels, iou, asy, valid = _instance(rng, agnostic=agnostic)
    params = dict(p_seed=0.1, cls_thr=0.25, iou_thr=0.5, con_thr=0.85, class_budget=budget)
    want = jcim.cim_mine(*_j(cls, det, labels, iou, asy, valid), jcim.MiningParams(**params))
    got = tcim.cim_mine(*_t(cls, det, labels, iou, asy, valid), tcim.MiningParams(**params))
    assert got.gt_mask.any()
    _assert_mined(got, want)


def test_cim_mine_ties_match_jax():
    rng = np.random.RandomState(7)
    cls, det, labels, iou, asy, valid = _instance(rng, n_labels=5, quantize=True)
    want = jcim.cim_mine(*_j(cls, det, labels, iou, asy, valid), jcim.MiningParams())
    got = tcim.cim_mine(*_t(cls, det, labels, iou, asy, valid), tcim.MiningParams())
    _assert_mined(got, want)


def test_cim_mine_chunks_classes_as_jax():
    """80 classes (COCO): the containment mining runs in class chunks."""
    rng = np.random.RandomState(3)
    cls, det, labels, iou, asy, valid = _instance(rng, c=80, n_labels=4)
    want = jcim.cim_mine(*_j(cls, det, labels, iou, asy, valid), jcim.MiningParams())
    got = tcim.cim_mine(*_t(cls, det, labels, iou, asy, valid), tcim.MiningParams())
    _assert_mined(got, want)


@pytest.mark.parametrize("budget", [0, 4])
@pytest.mark.parametrize("quantize", [False, True], ids=["float", "ties"])
def test_mist_mine_matches_jax(quantize, budget):
    rng = np.random.RandomState(4)
    cls, det, labels, iou, _, valid = _instance(rng, quantize=quantize)
    preds = cls * det
    params = dict(class_budget=budget)
    want = jcim.mist_mine(*_j(preds, labels, iou, valid), jcim.MiningParams(**params))
    got = tcim.mist_mine(*_t(preds, labels, iou, valid), tcim.MiningParams(**params))
    _assert_mined(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assign_pseudo_labels_matches_jax(seed):
    rng = np.random.RandomState(seed)
    cls, det, labels, iou, asy, valid = _instance(rng)
    params = dict(cls_thr=0.35, iou_thr=0.6)
    jp, tp = jcim.MiningParams(**params), tcim.MiningParams(**params)
    jm = jcim.cim_mine(*_j(cls, det, labels, iou, asy, valid), jp)
    tm = tcim.cim_mine(*_t(cls, det, labels, iou, asy, valid), tp)
    want = jcim.assign_pseudo_labels(jm, jnp.asarray(iou), jnp.asarray(valid), jp)
    got = tcim.assign_pseudo_labels(tm, *_t(iou, valid), tp)
    np.testing.assert_array_equal(got.pseudo_labels.numpy(), np.asarray(want.pseudo_labels))
    np.testing.assert_array_equal(got.pseudo_iou_labels.numpy(),
                                  np.asarray(want.pseudo_iou_labels))
    np.testing.assert_allclose(got.loss_weights.numpy(), np.asarray(want.loss_weights),
                               **FLOAT_TOL)
    assert bool(got.has_gt) == bool(want.has_gt)
    assert int(got.gt_count) == int(want.gt_count) > 0
    assert not got.pseudo_labels.numpy()[~valid].any()


def _uniforms(key, c, k_draw):
    """cim_tpu's draws: one uniform vector per class from split keys
    (cim_tpu/mining/cim.py anti_noise_resample)."""
    return np.array(jax.vmap(lambda k: jax.random.uniform(k, (k_draw,)))(
        jax.random.split(key, c)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_anti_noise_resample_matches_jax(seed):
    rng = np.random.RandomState(seed)
    cls, det, labels, iou, asy, valid = _instance(rng, n_labels=4)
    jm = jcim.cim_mine(*_j(cls, det, labels, iou, asy, valid), jcim.MiningParams())
    tm = tcim.cim_mine(*_t(cls, det, labels, iou, asy, valid), tcim.MiningParams())
    n, c = cls.shape
    k_draw = jcim.max_seeds(0.1, n)
    key = jax.random.PRNGKey(100 + seed)
    want = jcim.anti_noise_resample(jm, jnp.asarray(labels), key, max_draws=k_draw)
    got = tcim.anti_noise_resample(tm, torch.from_numpy(labels), max_draws=k_draw,
                                   uniforms=torch.from_numpy(_uniforms(key, c, k_draw)))
    _assert_mined(got, want)
    assert got.gt_mask.sum() <= tm.gt_mask.sum()


def test_anti_noise_resample_draws_from_generator():
    """Without injected uniforms the draws come from the generator: the
    same seed gives the same survivors."""
    rng = np.random.RandomState(5)
    cls, det, labels, iou, asy, valid = _instance(rng, n_labels=4)
    mined = tcim.cim_mine(*_t(cls, det, labels, iou, asy, valid), tcim.MiningParams())
    outs = [tcim.anti_noise_resample(mined, torch.from_numpy(labels),
                                     torch.Generator().manual_seed(9), max_draws=7).gt_mask
            for _ in range(2)]
    torch.testing.assert_close(outs[0], outs[1])
    assert (outs[0] <= mined.gt_mask).all()


@pytest.mark.parametrize("using_cim", [True, False])
def test_cim_layer_matches_jax(using_cim):
    """The full layer on (N, C+1) head outputs with anti-noise on."""
    rng = np.random.RandomState(11)
    cls, det, labels, iou, asy, valid = _instance(rng, n_labels=3)
    bg = np.full((cls.shape[0], 1), 0.05, np.float32)
    cls1, det1 = np.concatenate([bg, cls], 1), np.concatenate([bg, det], 1)
    params = dict(cls_thr=0.35, iou_thr=0.6, anti_noise=True)
    key = jax.random.PRNGKey(3)
    want = jcim.cim_layer(*_j(cls1, det1, labels, iou, asy, valid),
                          jcim.MiningParams(**params), key, using_cim=using_cim)
    k_draw = jcim.max_seeds(0.1, cls.shape[0])
    got = tcim.cim_layer(*_t(cls1, det1, labels, iou, asy, valid),
                         tcim.MiningParams(**params), using_cim=using_cim,
                         uniforms=torch.from_numpy(_uniforms(key, 20, k_draw)))
    np.testing.assert_array_equal(got.pseudo_labels.numpy(), np.asarray(want.pseudo_labels))
    np.testing.assert_array_equal(got.pseudo_iou_labels.numpy(),
                                  np.asarray(want.pseudo_iou_labels))
    np.testing.assert_allclose(got.loss_weights.numpy(), np.asarray(want.loss_weights),
                               **FLOAT_TOL)
    assert int(got.gt_count) == int(want.gt_count)


@pytest.mark.parametrize("p_seed", [0.1, 0.05])
def test_seed_count_is_the_float32_ceil(p_seed):
    """Every valid count a bucket can hold: ceil of the float32 product,
    as the count computed from a float32 copy of p_seed on the device was."""
    n = torch.arange(4097)
    got = tcim.seed_count(p_seed, n)
    want = np.ceil(np.float32(p_seed) * np.arange(4097, dtype=np.float32)).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)
    old = torch.ceil(torch.tensor(p_seed, dtype=torch.float32) * n.float()).to(torch.int64)
    assert torch.equal(got, old)
    assert int(tcim.seed_count(p_seed, torch.tensor(2560))) == want[2560]


@pytest.mark.parametrize("c1,dtype", [(21, torch.float32), (81, torch.bfloat16)])
def test_background_onehot_is_the_host_written_one(c1, dtype):
    old = torch.zeros((c1,), dtype=dtype)
    old[0] = 1.0
    got = tcim.background_onehot(c1, dtype, torch.device("cpu"))
    assert got.dtype == dtype and torch.equal(got, old)


@pytest.mark.parametrize("using_cim", [True, False])
def test_drawn_uniforms_mine_what_the_generator_draws(using_cim):
    rng = np.random.RandomState(12)
    cls, det, labels, iou, asy, valid = _t(*_instance(rng, n_labels=3))
    params = tcim.MiningParams(cls_thr=0.35, iou_thr=0.6, anti_noise=True)
    gen = torch.Generator().manual_seed(21)
    want = tcim.cim_layer(cls, det, labels, iou, asy, valid, params, gen, using_cim=using_cim)
    gen.manual_seed(21)
    u = tcim.draw_uniforms(cls, det, labels, params, gen, using_cim=using_cim)
    got = tcim.cim_layer(cls, det, labels, iou, asy, valid, params, using_cim=using_cim,
                         uniforms=u)
    assert int(want.gt_count) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _branches(rng, n_branches=3, budget=0):
    """Three branches' sources (head outputs with a background column),
    their ramped params and drawn uniforms, float16 maps as a batch holds
    them."""
    cls, det, labels, iou, asy, valid = _instance(rng, n_labels=3)
    sources = []
    for _ in range(n_branches):
        bg = rng.uniform(0, 0.1, (cls.shape[0], 1)).astype(np.float32)
        noise = rng.uniform(0.9, 1.1, cls.shape).astype(np.float32)
        sources.append((torch.from_numpy(np.concatenate([bg, cls * noise], 1)),
                        torch.from_numpy(np.concatenate([bg, det * noise], 1))))
    params = [tcim.MiningParams(cls_thr=0.25 + 0.1 * k, iou_thr=0.5 + 0.1 * k,
                                anti_noise=k != 1, class_budget=budget)
              for k in range(n_branches)]
    gen = torch.Generator().manual_seed(int(rng.randint(1 << 30)))
    uniforms = [tcim.draw_uniforms(c, d, torch.from_numpy(labels), p, gen)
                if p.anti_noise else None for (c, d), p in zip(sources, params)]
    maps = [torch.from_numpy(m).half() for m in (iou, asy)]
    return sources, torch.from_numpy(labels), maps, torch.from_numpy(valid), params, uniforms


@pytest.mark.parametrize("budget", [0, 4])
def test_mine_branches_on_the_cpu_is_each_branch_cim_layer(budget):
    """On CPU tensors mine_branches runs op by op, with graphs or without,
    and counts one eager run a call."""
    sources, labels, (iou, asy), valid, params, uniforms = _branches(
        np.random.RandomState(13), budget=budget)
    graphs = tcim.MiningGraphs()
    got = tcim.mine_branches(sources, labels, iou, asy, valid, params, uniforms, graphs=graphs)
    assert (graphs.captures, graphs.replays, graphs.eager_runs) == (0, 0, 1)
    assert len(graphs) == 0 and graphs.device_bytes() == (0, 0)
    for (c, d), p, u, pl in zip(sources, params, uniforms, got):
        want = tcim.cim_layer(c, d, labels, iou.float(), asy.float(), valid, p, uniforms=u)
        for a, b in zip(pl, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert bool(got[0].has_gt)
    with pytest.raises(ValueError, match="uniforms"):
        tcim.mine_branches(sources, labels, iou, asy, valid, params, [None] * 3)


def test_mining_graph_key_follows_bucket_classes_and_params():
    params = [tcim.MiningParams(cls_thr=0.25 + 0.1 * k) for k in range(3)]

    def key(n=2048, c=20, ps=params, using_cim=True, dtype=torch.float32):
        inputs = [torch.zeros(n, c + 1, dtype=dtype) for _ in range(6)] + [
            torch.zeros(c), torch.zeros(n, n, dtype=torch.float16),
            torch.zeros(n, n, dtype=torch.float16), torch.zeros(n, dtype=torch.bool)]
        return tcim.mining_graph_key(inputs, ps, using_cim)

    base = key()
    assert key() == base and hash(key()) == hash(base)  # fresh tensors, the same key
    budget = [p._replace(class_budget=4) for p in params]
    thresholds = [p._replace(cls_thr=p.cls_thr + 0.05) for p in params]
    others = [key(n=2560), key(c=80), key(using_cim=False), key(ps=budget),
              key(ps=thresholds), key(dtype=torch.bfloat16)]
    assert len({base, *others}) == 1 + len(others)
