"""Host input pipeline: roidb -> fixed-shape batches with prefetch
(port of cim_tpu/data/loader.py, one device).

Plain numpy on the host, as in cim_tpu, which replaced the reference's
torch DataLoader stack (lib/roi_data/loader.py, minibatch.py) with this
design; the port keeps it so that the same seed gives the same arrays:

- every microbatch is FIXED SHAPE: proposals padded/sampled to
  cfg.TPU.PROPOSAL_PAD with a validity mask; images resized by a
  per-*step* random scale from TRAIN.SCALES and zero-padded to a
  (H, W) bucket (multiples of TPU.PAD_MULTIPLE);
- a training step's grad_accum images are drawn from the same
  (scale, aspect-bucket) group so they stack into one array (the
  reference regroups nothing; fixed shapes keep the device's memory
  plan and cuDNN's algorithm choice stable). Marginal scale distribution
  per image is preserved;
- per-image IoU / asymmetric-IoU matrices are joined HERE (bundled into
  the batch), not re-read from pickles inside model.forward like the
  reference (model_builder.py:147-159); they stay float16 on the host and
  are upcast on the device (mining.cim.mine_branches);
- proposal subsampling beyond the cap applies consistently to
  boxes/masks/mat/iou matrices (the reference's _sample_rois
  minibatch.py:92-106 samples only boxes — latent bug since the cap of
  4096 rarely triggers; here the cap is load-bearing so it is correct);
- background-thread prefetch replaces worker processes; with
  ``pin_memory`` the producer threads also copy each batch into pinned
  host memory (pin_batch), so that the trainer's copies to the card are
  asynchronous and the main thread pins nothing.
"""
from __future__ import annotations

import logging
import os
import pickle
import queue
import threading
import time

import numpy as np
import torch

from cim_tpu_torch.data.transforms import prep_image, scale_for_target

logger = logging.getLogger(__name__)

PAD_MULTIPLE = 128


def _bucket_hw(h: int, w: int, multiple: int = PAD_MULTIPLE):
    pad = lambda x: int(np.ceil(x / multiple) * multiple)
    return pad(h), pad(w)


def load_iou_maps(cfg, entry, index):
    """Load per-image (iou, asy_iou) from cfg.iou_dir / cfg.asy_iou_dir
    pkls (reference model_builder.py:147-159), subset to sampled index.
    Entries may also carry inline 'iou_map'/'asy_iou_map' (synthetic /
    pre-joined datasets)."""
    if "iou_map" in entry:
        iou = np.asarray(entry["iou_map"], np.float16)
        asy = np.asarray(entry["asy_iou_map"], np.float16)
    else:
        file_name = os.path.splitext(os.path.basename(entry["image"]))[0]
        with open(os.path.join(cfg.iou_dir, file_name + ".pkl"), "rb") as f:
            iou = np.asarray(pickle.load(f), np.float16)
        with open(os.path.join(cfg.asy_iou_dir, file_name + ".pkl"), "rb") as f:
            asy = np.asarray(pickle.load(f), np.float16)
    # stay f16 end to end: the batch ships f16 and the device upcasts
    # (mining.cim.mine_branches), with no host copy for the identity
    # subset
    n = iou.shape[0]
    index = np.asarray(index)
    # identity fast path: must check full monotonicity, not just the
    # endpoints — an unsorted permutation would otherwise silently get
    # un-permuted IoU maps
    if len(index) == n and n > 0 and index[0] == 0 and (np.diff(index) == 1).all():
        return iou, asy  # full contiguous subset: no gather needed
    iou = iou[np.ix_(index, index)]
    asy = asy[np.ix_(index, index)]
    return iou, asy


def pin_batch(batch):
    """A batch's arrays as torch tensors in pinned (page-locked) host
    memory, image_hw left as it is: each array is copied once into a
    block of PyTorch's caching host allocator. That allocator records the
    stream of every non_blocking copy out of a block and hands the block
    out again only after the copy has run, so dropping the batch while its
    copies are queued is safe. Pinning needs a CUDA device."""
    return {k: v if k == "image_hw" else torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
            for k, v in batch.items()}


def proposal_bucket(cfg, n: int) -> int:
    """Smallest configured proposal bucket >= n (capped at PROPOSAL_PAD).

    Proposal-count bucketing: padding every image to the flat 4096 cap
    would double the MaskFuse/head work at the typical ~2000 COB
    proposals per VOC image.
    """
    cap = cfg.TPU.PROPOSAL_PAD
    for b in sorted(cfg.TPU.PROPOSAL_BUCKETS or ()):
        if n <= b <= cap:
            return int(b)
    return int(cap)


def build_microbatch(cfg, entry, im_scale, bucket_hw, rng, image=None,
                     n_max=None):
    """One fixed-shape training microbatch from an roidb entry."""
    n_max = n_max if n_max is not None else cfg.TPU.PROPOSAL_PAD
    num_classes = cfg.MODEL.NUM_CLASSES

    if image is None:
        import cv2

        image = cv2.imread(entry["image"])
        assert image is not None, f"cannot read {entry['image']}"
        if entry.get("flipped"):
            image = image[:, ::-1, :]

    im = prep_image(image, im_scale, cfg.transform_mode, cfg.PIXEL_MEANS)
    hb, wb = bucket_hw
    im_p = np.zeros((hb, wb, 3), np.float32)
    im_p[: im.shape[0], : im.shape[1]] = im

    boxes = entry["boxes"]
    n = boxes.shape[0]
    if n > n_max:
        index = rng.permutation(n)[:n_max]
        index.sort()
    else:
        index = np.arange(n)
    n_keep = len(index)

    rois = np.zeros((n_max, 4), np.float32)
    rois[:n_keep] = boxes[index] * im_scale
    masks = np.zeros((n_max,) + entry["masks"].shape[1:], np.float32)
    masks[:n_keep] = entry["masks"][index]
    valid = np.zeros(n_max, bool)
    valid[:n_keep] = True

    mat = np.zeros((n_max, num_classes + 1), np.int32)
    if len(entry["mat"]):
        mat[:n_keep] = entry["mat"][index].astype(np.int32)

    iou_map = np.zeros((n_max, n_max), np.float16)
    asy_map = np.zeros((n_max, n_max), np.float16)
    iou, asy = load_iou_maps(cfg, entry, index)
    iou_map[:n_keep, :n_keep] = iou
    asy_map[:n_keep, :n_keep] = asy

    labels = entry["gt_classes"].reshape(-1)[:num_classes].astype(np.float32)
    budget = int(cfg.TPU.MINING_CLASS_BUDGET)
    if 0 < budget < num_classes and labels.sum() > budget:
        # exactness condition of the class-budgeted mining (mining/cim.py
        # _budget_select): every label class must fit the static budget
        raise ValueError(
            f"image {entry.get('image', '?')} has {int(labels.sum())} label "
            f"classes > TPU.MINING_CLASS_BUDGET={budget}; raise the budget"
        )

    return {
        "image": im_p,
        # true extent inside the zero-padded bucket: drives valid-extent
        # masking in the model (cim_tpu_torch.models.layers.mask_valid_hw)
        "image_hw": np.array([im.shape[0], im.shape[1]], np.int32),
        "rois": rois,
        "masks": masks,
        "valid": valid,
        "labels": labels,
        "mat": mat,
        "iou_map": iou_map,
        "asy_iou_map": asy_map,
    }


class TrainLoader:
    """Iterator over stacked (grad_accum, ...) batches for one device.

    Epoch permutation + per-step random scale (reference
    MinibatchSampler loader.py:87-104 + scale choice minibatch.py:112).
    Groups same-bucket images so microbatches stack; a background thread
    keeps `prefetch` batches ready.

    In a data-parallel run each rank builds one over its own strided
    shard (parallel.host_shard_roidb) with the run's seed, as each host
    of cim_tpu's --multihost does: rank r permutes its shard with
    RandomState(seed), and ranks with shards of one length draw the same
    scale sequence, so their buckets, and step times, match. A resumed
    run passes start=step on every rank.
    """

    def __init__(self, cfg, roidb, grad_accum: int, seed: int = 3,
                 prefetch: int = 2, num_workers: int | None = None,
                 pin_memory: bool = False, start: int = 0):
        """pin_memory: hand out batches pinned by pin_batch (for a CUDA
        trainer), pinned in the threads that build them. start: the number
        of batches of the seed's sequence to pass over (built and dropped
        where they draw from the loader's own generator), so that a resumed
        run continues the sequence where its checkpoint left it."""
        self.cfg = cfg
        self.pin_memory = pin_memory
        self.start = start
        self.build_seconds: list = []  # host time of each batch built
        self.roidb = roidb
        self.grad_accum = grad_accum
        self.per_step = grad_accum
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.prefetch = prefetch
        # worker pool for the microbatch builds (numpy/cv2/pickle work) —
        # cfg.DATA_LOADER.NUM_THREADS mirrors the reference's dataloader
        # workers (tools/train.py:266-270). The scheduler (epoch
        # permutation, scale draw, bucket grouping) stays single-threaded
        # and deterministic; groups are dispatched to the pool and their
        # futures consumed IN ORDER, with a per-group derived RandomState,
        # so the batch sequence is seed-deterministic regardless of
        # worker timing.
        if num_workers is None:
            # cap at the core count: on a single-core host the pool only
            # adds GIL contention
            num_workers = min(cfg.DATA_LOADER.NUM_THREADS, os.cpu_count() or 1)
        self.num_workers = num_workers
        depth = prefetch + (self.num_workers if self.num_workers > 1 else 0)
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = None
        self._pool = None

    # -------------------------------------------------------------- #
    def _entry_bucket(self, entry, scale):
        h, w = entry["height"], entry["width"]
        s = scale_for_target((h, w), scale, self.cfg.TRAIN.MAX_SIZE)
        m = int(self.cfg.TPU.PAD_MULTIPLE or PAD_MULTIPLE)
        return _bucket_hw(int(round(h * s)), int(round(w * s)), m), s

    def _produce(self):
        scales = list(self.cfg.TRAIN.SCALES)
        pending: dict = {}
        epoch_order = []
        pos = 0
        group_idx = 0
        while not self._stop.is_set():
            if pos >= len(epoch_order):
                epoch_order = self.rng.permutation(len(self.roidb))
                pos = 0
            entry = self.roidb[epoch_order[pos]]
            pos += 1
            scale = scales[self.rng.randint(len(scales))]
            bucket, s = self._entry_bucket(entry, scale)
            n_bucket = proposal_bucket(self.cfg, len(entry["boxes"]))
            key = (scale, bucket, n_bucket)
            pending.setdefault(key, []).append((entry, s))
            if len(pending[key]) >= self.per_step:
                group = pending.pop(key)[: self.per_step]
                if group_idx < self.start:
                    if self._pool is None:
                        # build it and drop it, so that it takes from the
                        # shared generator what it would have taken, and
                        # the batches after it come out as they would have;
                        # the pool's builds draw from their own generators
                        for e, s in group:
                            build_microbatch(self.cfg, e, s, bucket, self.rng, n_max=n_bucket)
                    group_idx += 1
                    continue
                if self._pool is not None:
                    grp_rng = np.random.RandomState(
                        (self.seed * 1000003 + group_idx) % (2**32)
                    )
                    item = self._pool.submit(
                        self._stack, group, bucket, n_bucket, grp_rng
                    )
                else:
                    item = self._stack(group, bucket, n_bucket)
                group_idx += 1
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue

    def _stack(self, group, bucket, n_bucket=None, rng=None):
        rng = rng if rng is not None else self.rng
        t0 = time.perf_counter()
        mbs = [
            build_microbatch(self.cfg, e, s, bucket, rng, n_max=n_bucket)
            for e, s in group
        ]
        batch = {key: np.stack([mb[key] for mb in mbs]) for key in mbs[0]}
        batch = pin_batch(batch) if self.pin_memory else batch
        self.build_seconds.append(time.perf_counter() - t0)
        return batch

    # -------------------------------------------------------------- #
    def __iter__(self):
        if self._thread is None:
            if self.num_workers > 1:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(
                    max_workers=self.num_workers,
                    thread_name_prefix="cim_loader",
                )
            self._thread = threading.Thread(target=self._produce, daemon=True)
            self._thread.start()
        return self

    def __next__(self):
        item = self._queue.get()
        return item.result() if hasattr(item, "result") else item

    def close(self):
        self._stop.set()
        # drain so a blocked put() observes the stop event
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._pool is not None:
            # let running builds end before the caller may remove their files
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
