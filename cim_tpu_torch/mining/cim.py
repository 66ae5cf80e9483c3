"""Complete Instances Mining (port of cim_tpu/mining/cim.py).

The reference's CIM_layer (lib/modeling/heads.py:222-502) as fixed-shape
tensor ops on the proposals' device, the same algorithm as cim_tpu:

- seed selection + mask-IoU NMS for all classes at once: classes are a
  leading batch axis (cim_tpu's vmap), and the NMS round loop is shared;
- complete-instance mining (containment via the asymmetric-IoU matrix,
  detector-argmax per seed column) as a masked argmax over a
  (classes, N, K) tensor, run in chunks of _CLASS_CHUNK classes above that
  count to bound the intermediate;
- the "higher-scoring class wins" update (heads.py:397-402) as an argmax
  over classes, whose first-max rule picks the lowest class index;
- anti-noise resampling by CDF inversion of uniform draws from a
  torch.Generator, or of uniforms the caller passes in (draw_uniforms draws
  them ahead; the tests feed it cim_tpu's jax.random draws).

Which path runs where: the seed NMS is ops/nms.greedy_nms_from_iou, a
hand-written kernel on CUDA tensors and the plain round loop on CPU
tensors; nothing else in mining reads a device value on the host, so on
the card a mining call never waits for it. mine_branches runs every refine
branch of one image; given a MiningGraphs and CUDA tensors it replays them
as one CUDA graph captured for the inputs' key, else it runs them op by
op.

Tie rules follow cim_tpu: stable sorts (jnp.argsort is stable), first-max
argmax, and scatter-max with duplicate indices as ``scatter_reduce``
"amax". Inputs are padded to N with a validity mask; padding rows are
never mined and get zero labels and weights. Mining takes no gradient:
callers pass detached scores.
"""
from __future__ import annotations

import math
import struct
from typing import List, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from cim_tpu_torch.ops.nms import greedy_nms_from_iou
from cim_tpu_torch.utils.trace import span

NEG = -1e30

# Class-chunk bound for the containment mining: caps the (chunk, N, K)
# intermediate; VOC's 20 classes run as one chunk.
_CLASS_CHUNK = 32


class MiningParams(NamedTuple):
    """Thresholds of one CIM_layer (reference heads.py:223-230 and
    model_builder.py:90-94: cls_thr = 0.25 + step_rate*k,
    iou_thr = 0.5 + step_rate*k, nms_thr == cls_thr). class_budget > 0
    mines only a present-first selection of that many classes, exact
    while every image's label count fits it."""

    p_seed: float = 0.1
    cls_thr: float = 0.25
    iou_thr: float = 0.5
    con_thr: float = 0.85
    anti_noise: bool = True
    class_budget: int = 0

    @property
    def nms_thr(self) -> float:
        return self.cls_thr


class MinedGT(NamedTuple):
    gt_labels: torch.Tensor  # (N, C+1) one-hot mined pseudo-GT labels
    gt_weights: torch.Tensor  # (N,) mined scores (-1 where not mined)
    gt_mask: torch.Tensor  # (N,) bool, mined rows
    asy_iou_flag: torch.Tensor  # (N,) bool, False = "big" proposal


class PseudoLabels(NamedTuple):
    pseudo_labels: torch.Tensor  # (N, C+1)
    pseudo_iou_labels: torch.Tensor  # (N,)
    loss_weights: torch.Tensor  # (N,)
    has_gt: torch.Tensor  # () bool: the reference's None return, inverted
    gt_count: torch.Tensor  # () int32: mined pseudo-GT rows (health metric)


def seed_count(p_seed: float, n_valid: torch.Tensor) -> torch.Tensor:
    """keep_count = ceil(p_seed * N) in float32, N the valid proposal count
    (reference heads.py:332). p_seed is rounded to float32 on the host and
    enters the product as a scalar argument: nothing is copied to the
    device. The product of two float32 values is the same rounded in
    float32 or in double, so the kernel's arithmetic type cannot move it."""
    p32 = struct.unpack("f", struct.pack("f", p_seed))[0]
    return torch.ceil(n_valid.float() * p32).to(torch.int64)


def max_seeds(p_seed: float, n_max: int) -> int:
    return int(math.ceil(p_seed * n_max))


def _map_classes(fn, args, c):
    """fn over the leading class axis of every arg, in chunks of
    _CLASS_CHUNK classes (cim_tpu's vmap / lax.map over chunks)."""
    if c <= _CLASS_CHUNK:
        return fn(*args)
    return torch.cat([fn(*(a[i:i + _CLASS_CHUNK] for a in args))
                      for i in range(0, c, _CLASS_CHUNK)])


def _scatter_max(n, idx, vals):
    """(B, N) bool: out[b, idx[b, k]] = max over k of vals[b, k], from
    False (cim_tpu's zeros(n, bool).at[idx].max(vals))."""
    out = torch.zeros(idx.shape[0], n, dtype=torch.int32, device=idx.device)
    out.scatter_reduce_(1, idx, vals.to(torch.int32), "amax", include_self=True)
    return out > 0


def _winner_reduce(eligible, scores_cn, num_classes, dtype, class_ids=None):
    """The reference's sequential "higher-scoring class wins" update as a
    first-max argmax over classes (lowest class index among ties).
    eligible / scores_cn: (C_sel, N); class_ids (C_sel,) maps a row to its
    original class under a class budget. Returns (gt_labels (N, C+1),
    gt_weights (N,), gt_mask (N,))."""
    cand = torch.where(eligible, scores_cn, NEG)
    winner = torch.argmax(cand, dim=0)
    mined = eligible.any(dim=0)
    best = cand.amax(dim=0)
    if class_ids is not None:
        winner = class_ids[winner]
    gt_labels = F.one_hot(winner + 1, num_classes + 1).to(dtype) * mined[:, None].to(dtype)
    gt_weights = torch.where(mined, best, torch.full_like(best, -1.0)).to(dtype)
    return gt_labels, gt_weights, mined


def _budget_select(labels, budget: int):
    """Present classes first, each group in ascending class index (stable
    sort of the 0/1 labels), truncated to ``budget``."""
    return torch.sort(-labels, stable=True).indices[:budget]


def _seeds_and_nms(scores_cn, iou_map, valid, keep_count, k_seed, nms_thr):
    """For every class at once: top-k seeds + greedy mask-IoU NMS.
    scores_cn: (C, N). Returns (seed_idx (C, K), keep_seed (C, K) bool)."""
    masked = torch.where(valid[None, :], scores_cn, NEG)
    seed_idx = torch.sort(-masked, dim=-1, stable=True).indices[:, :k_seed]
    pos = torch.arange(k_seed, device=scores_cn.device)
    seed_valid = (pos < keep_count)[None, :] & valid[seed_idx]
    iou_seed = iou_map[seed_idx[:, :, None], seed_idx[:, None, :]]  # (C, K, K)
    seed_scores = torch.gather(masked, 1, seed_idx)
    keep_seed = greedy_nms_from_iou(iou_seed, seed_scores, nms_thr, valid=seed_valid)
    return seed_idx, keep_seed


def cim_mine(predict_cls, predict_det, labels, iou_map, asy_iou_map, valid,
             params: MiningParams) -> MinedGT:
    """CIM pseudo-GT mining (reference CIM_label, heads.py:319-407).

    predict_cls: (N, C) class scores, background stripped; predict_det:
    (N, C) detector scores or (N, 1) class-agnostic; labels: (C,) multi-hot;
    iou_map / asy_iou_map: (N, N) float (asy[i, j] = extent to which i
    contains j); valid: (N,) bool.
    """
    n, c = predict_cls.shape
    num_classes = c
    dtype = predict_cls.dtype
    n_valid = valid.sum()
    keep_count = seed_count(params.p_seed, n_valid)
    k_seed = max_seeds(params.p_seed, n)

    det = predict_det.expand(n, c) if predict_det.shape[-1] == 1 else predict_det
    preds = predict_cls * det

    budget = int(params.class_budget or 0)
    sel = _budget_select(labels, budget) if 0 < budget < c else None
    if sel is not None:
        predict_cls, det, preds, labels = predict_cls[:, sel], det[:, sel], preds[:, sel], labels[sel]
        c = budget

    # big-proposal filter (heads.py:338): row i is "big" when it contains
    # > 90% of the valid proposals
    vcol = valid.to(dtype)
    contain_counts = ((asy_iou_map > params.con_thr).to(dtype) * vcol[None, :]).sum(-1)
    asy_iou_flag = (contain_counts < 0.9 * n_valid.to(dtype)) & valid

    # phase A: per-class seeds + NMS
    seed_idx, keep_seed = _seeds_and_nms(predict_cls.T, iou_map, valid, keep_count,
                                         k_seed, params.nms_thr)

    # phase B: containment mining + winner reduction
    row_ok = asy_iou_flag & valid

    def chosen(s_idx, s_keep, det_c):
        asy_seed = asy_iou_map[:, s_idx].permute(1, 0, 2)  # (C, N, K): rows contain seed cols
        contain = (asy_seed > params.con_thr) & row_ok[None, :, None]
        col_has = contain.any(dim=1) & s_keep  # (C, K)
        cand = torch.where(contain, det_c[:, :, None], NEG)
        col_arg = torch.argmax(cand, dim=1)  # (C, K): detector argmax per seed column
        return _scatter_max(n, col_arg, col_has)  # union over columns

    mined = _map_classes(chosen, (seed_idx, keep_seed, det.T), c)
    eligible = mined & (labels > 0)[:, None]
    gt_labels, gt_weights, gt_mask = _winner_reduce(eligible, preds.T, num_classes, dtype,
                                                    class_ids=sel)
    return MinedGT(gt_labels, gt_weights, gt_mask, asy_iou_flag)


def mist_mine(preds, labels, iou_map, valid, params: MiningParams) -> MinedGT:
    """MIST fallback mining (reference MIST_label, heads.py:261-316):
    top-p seeds + NMS only, no containment step."""
    n, c = preds.shape
    num_classes = c
    dtype = preds.dtype
    keep_count = seed_count(params.p_seed, valid.sum())
    k_seed = max_seeds(params.p_seed, n)

    budget = int(params.class_budget or 0)
    sel = _budget_select(labels, budget) if 0 < budget < c else None
    if sel is not None:
        preds, labels = preds[:, sel], labels[sel]
        c = budget

    seed_idx, keep_seed = _seeds_and_nms(preds.T, iou_map, valid, keep_count, k_seed,
                                         params.nms_thr)
    kept = _map_classes(lambda s_idx, s_keep: _scatter_max(n, s_idx, s_keep),
                        (seed_idx, keep_seed), c)
    eligible = kept & (labels > 0)[:, None]
    gt_labels, gt_weights, gt_mask = _winner_reduce(eligible, preds.T, num_classes, dtype,
                                                    class_ids=sel)
    return MinedGT(gt_labels, gt_weights, gt_mask, valid.clone())


def anti_noise_resample(mined: MinedGT, labels, generator=None,
                        max_draws: int | None = None, uniforms=None) -> MinedGT:
    """Anti-noise sampling (reference heads.py:437-474): per class, draw
    n_c samples with replacement over that class's mined GT, weighted by
    gt_weights; survivors are the union of draws.

    The draws are CDF inversions of uniforms: ``uniforms`` (C, K) if given
    (K = max_draws or N), else torch.rand from ``generator``. Draw t of
    class c hits row i iff cdf[i-1] < u[c, t] <= cdf[i], counted for the
    first n_c draws only; a draw beyond cdf[-1] lands on the last row.
    """
    n, c1 = mined.gt_labels.shape
    c = c1 - 1
    k_draw = n if max_draws is None else min(int(max_draws), n)
    dev = mined.gt_labels.device
    weights = mined.gt_weights

    members = (mined.gt_labels[:, 1:] == 1).T & (labels > 0)[:, None]  # (C, N)
    n_c = members.sum(dim=1)  # (C,)
    pos = members & (weights > 0)[None, :]
    w_pos = torch.where(pos, weights[None, :], torch.zeros_like(pos, dtype=weights.dtype))
    mem_f = members.to(weights.dtype)
    # all-zero weights would raise in the reference: uniform over members
    p = torch.where(
        pos.any(dim=1, keepdim=True),
        w_pos / w_pos.sum(dim=1, keepdim=True).clamp(min=1e-20),
        mem_f / mem_f.sum(dim=1, keepdim=True).clamp(min=1.0),
    )
    cdf = torch.cumsum(p, dim=1)  # (C, N)
    if uniforms is None:
        uniforms = torch.rand((c, k_draw), generator=generator, device=dev, dtype=cdf.dtype)
    if tuple(uniforms.shape) != (c, k_draw):
        raise ValueError(f"uniforms must be ({c}, {k_draw}), got {tuple(uniforms.shape)}")
    draw_on = torch.arange(k_draw, device=dev)[None, :] < n_c[:, None]
    masked_u = torch.where(draw_on, uniforms.to(cdf.dtype), torch.full_like(cdf[:, :1], 2.0))
    hits = (masked_u[:, None, :] <= cdf[:, :, None]).sum(dim=-1)  # (C, N)
    survive = torch.diff(hits, dim=1, prepend=torch.zeros_like(hits[:, :1])) > 0
    survive[:, n - 1] |= hits[:, n - 1] < n_c
    keep = survive.any(dim=0) | ~members.any(dim=0)
    gt_mask = mined.gt_mask & keep
    gt_labels = mined.gt_labels * gt_mask[:, None]
    gt_weights = torch.where(gt_mask, weights, torch.full_like(weights, -1.0))
    return MinedGT(gt_labels, gt_weights, gt_mask, mined.asy_iou_flag)


def background_onehot(c1: int, dtype, device) -> torch.Tensor:
    """(C+1,) one-hot of the background class, made on the device: no
    value is copied from the host."""
    return (torch.arange(c1, device=device) == 0).to(dtype)


def assign_pseudo_labels(mined: MinedGT, iou_map, valid, params: MiningParams) -> PseudoLabels:
    """IoU-based pseudo-label assignment (reference heads.py:476-502)."""
    c1 = mined.gt_labels.shape[1]
    dtype = mined.gt_labels.dtype

    ov = torch.where(mined.gt_mask[None, :], iou_map, torch.full_like(iou_map, -1.0))
    max_v = ov.amax(dim=-1)
    arg = torch.argmax(ov, dim=-1)  # first max, as jnp.argmax

    pseudo_labels = mined.gt_labels[arg]
    loss_weights = mined.gt_weights[arg]
    pseudo_iou = max_v.clamp(min=0.0)

    # no overlap with any mined GT -> fully ignored
    ignore = max_v <= 0.0
    pseudo_labels = torch.where(ignore[:, None], torch.zeros_like(pseudo_labels), pseudo_labels)
    loss_weights = torch.where(ignore, torch.zeros_like(loss_weights), loss_weights)

    # background assignment, and big proposals forced to background
    bg_onehot = background_onehot(c1, dtype, iou_map.device)
    bg = ((max_v < params.cls_thr) & ~ignore) | ~mined.asy_iou_flag
    pseudo_labels = torch.where(bg[:, None], bg_onehot[None, :], pseudo_labels)

    # binary iou target (heads.py:500-501)
    pseudo_iou = (pseudo_iou > params.iou_thr).to(dtype)

    # padding rows contribute nothing
    vf = valid.to(dtype)
    pseudo_labels = pseudo_labels * vf[:, None]
    loss_weights = loss_weights * vf
    pseudo_iou = pseudo_iou * vf

    has_gt = mined.gt_mask.any()
    gt_count = mined.gt_mask.sum().to(torch.int32)
    return PseudoLabels(pseudo_labels, pseudo_iou, loss_weights, has_gt, gt_count)


def cim_layer(predict_cls, predict_det, labels, iou_map, asy_iou_map, valid,
              params: MiningParams, generator=None, using_cim: bool = True,
              uniforms=None) -> PseudoLabels:
    """Full CIM_layer forward (reference heads.py:409-502).

    predict_cls / predict_det are (N, C+1) head outputs (bg at column 0) or
    already-stripped (N, C). With params.anti_noise the draws come from
    ``generator`` (or ``uniforms``, (C, max_seeds(p_seed, N)))."""
    c = labels.shape[-1]
    if predict_cls.shape[-1] == c + 1:
        predict_cls = predict_cls[:, 1:]
    if predict_det is not None and predict_det.shape[-1] == c + 1:
        predict_det = predict_det[:, 1:]

    if using_cim:
        mined = cim_mine(predict_cls, predict_det, labels, iou_map, asy_iou_map, valid,
                         params)
    else:
        preds = predict_cls * predict_det if predict_det is not None else predict_cls
        mined = mist_mine(preds, labels, iou_map, valid, params)

    if params.anti_noise:
        # mined rows per class are argmaxes of seed columns, so n_c is
        # bounded by the seed count
        mined = anti_noise_resample(
            mined, labels, generator,
            max_draws=max_seeds(params.p_seed, predict_cls.shape[0]), uniforms=uniforms,
        )
    return assign_pseudo_labels(mined, iou_map, valid, params)


def draw_uniforms(predict_cls, predict_det, labels, params: MiningParams, generator,
                  using_cim: bool = True) -> torch.Tensor:
    """The uniforms that cim_layer(..., generator=generator) draws for
    anti-noise sampling, drawn ahead of it with the same shape, dtype and
    generator: cim_layer(..., uniforms=draw_uniforms(...)) mines the same."""
    n, c = predict_cls.shape[0], labels.shape[-1]
    dtype = predict_cls.dtype
    if not using_cim and predict_det is not None:
        dtype = torch.result_type(predict_cls, predict_det)  # MIST mines their product
    k_draw = min(max_seeds(params.p_seed, n), n)
    return torch.rand((c, k_draw), generator=generator, device=predict_cls.device, dtype=dtype)


class MiningGraphs:
    """CUDA graphs of mine_branches, one a key, in one shared memory pool.

    The key is what mine_branches observes in its inputs: each tensor's
    shape, dtype and device (the proposal bucket N, the class count), the
    branches' MiningParams (thresholds, class budget) and using_cim. The
    first call with a key runs op by op (the warm-up, whose result it
    returns), then captures the graph. Each later call copies its inputs
    into the graph's static buffers, replays it and returns clones of its
    outputs, so that no replay overwrites a tensor a caller kept (autograd
    saves the pseudo labels for the losses' backward). The graphs share one
    pool: they run on one stream, one at a time, and a replay's outputs are
    cloned before the next replay. A capture synchronizes the device once.

    ``captures``, ``replays`` and ``eager_runs`` count the graphs captured,
    the calls that replayed one and those that ran op by op (the warm-ups,
    and every call on CPU tensors through mine_branches). A capture
    launches no kernel, so greedy_nms_from_iou.kernel_launches leaves it
    out and counts each replay's NMS launches instead.
    """

    def __init__(self):
        self._graphs = {}
        self._pool = None
        self.captures = self.replays = self.eager_runs = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def device_bytes(self):
        """(device bytes the shared pool holds, bytes of the graphs' static
        inputs): what the graphs keep for their life, apart from what each
        step allocates and frees. The pool's size is None where the
        allocator's snapshot does not tell segments' pools apart."""
        static = sum(t.numel() * t.element_size() for e in self._graphs.values() for t in e[0])
        if self._pool is None:
            return 0, static
        segments = torch.cuda.memory_snapshot()
        if segments and "segment_pool_id" not in segments[0]:
            return None, static
        pool = sum(s["total_size"] for s in segments
                   if tuple(s["segment_pool_id"]) == tuple(self._pool))
        return pool, static

    def run(self, key, fn, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        entry = self._graphs.get(key)
        if entry is None:
            outs = list(fn(*inputs))
            self.eager_runs += 1
            self._graphs[key] = self._capture(fn, inputs)
            self.captures += 1
            return outs
        static_in, static_out, graph, nms_launches = entry
        for dst, src in zip(static_in, inputs):
            dst.copy_(src)
        graph.replay()
        greedy_nms_from_iou.kernel_launches += nms_launches
        self.replays += 1
        return [t.clone() for t in static_out]

    def _capture(self, fn, inputs):
        static_in = [t.clone() for t in inputs]  # outside the pool: live for the graph's life
        graph = torch.cuda.CUDAGraph()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        launches = greedy_nms_from_iou.kernel_launches
        # capture_error_mode: the loader's threads may pin memory meanwhile
        with span("cim.sync"), torch.cuda.device(static_in[0].device), torch.cuda.graph(
                graph, pool=self._pool, capture_error_mode="thread_local"):
            static_out = list(fn(*static_in))
        # the wrapper counted the kernels it recorded; they launch at replay
        nms_launches = greedy_nms_from_iou.kernel_launches - launches
        greedy_nms_from_iou.kernel_launches = launches
        return static_in, static_out, graph, nms_launches


def mining_graph_key(inputs: Sequence[torch.Tensor], params: Sequence[MiningParams],
                     using_cim: bool) -> tuple:
    """MiningGraphs' key of mine_branches' inputs: each tensor's shape,
    dtype and device, the branches' MiningParams and using_cim."""
    return (tuple((tuple(t.shape), t.dtype, t.device) for t in inputs), tuple(params),
            bool(using_cim))


def mine_branches(sources, labels, iou_map, asy_iou_map, valid, params: Sequence[MiningParams],
                  uniforms, using_cim: bool = True,
                  graphs: MiningGraphs | None = None) -> List[PseudoLabels]:
    """cim_layer of every refine branch of one image: branch k mines
    sources[k] = (predict_cls, predict_det) with params[k] and, with
    anti-noise sampling, uniforms[k] (draw_uniforms; None without). labels,
    the IoU maps (float16 or float32, upcast here) and valid are the
    batch's. With ``graphs`` and CUDA tensors every branch runs in one
    replay of the graph for these inputs' key; else op by op."""
    nb = len(params)
    drawn = [u for p, u in zip(params, uniforms) if p.anti_noise]
    if any(u is None for u in drawn):
        raise ValueError("anti-noise sampling needs each branch's uniforms")
    inputs = [t for pair in sources for t in pair] + [labels, iou_map, asy_iou_map, valid] + drawn

    def mine(*flat):
        lab, iou, asy, val = flat[2 * nb:2 * nb + 4]
        lab, iou, asy = lab.float(), iou.float(), asy.float()
        us = iter(flat[2 * nb + 4:])
        out = []
        for k, p in enumerate(params):
            out += cim_layer(flat[2 * k], flat[2 * k + 1], lab, iou, asy, val, p,
                             using_cim=using_cim, uniforms=next(us) if p.anti_noise else None)
        return out

    with torch.no_grad():
        if graphs is not None and valid.device.type == "cuda":
            flat = graphs.run(mining_graph_key(inputs, params, using_cim), mine, inputs)
        else:
            flat = mine(*inputs)
            if graphs is not None:
                graphs.eager_runs += 1
    return [PseudoLabels(*flat[5 * k:5 * k + 5]) for k in range(nb)]
