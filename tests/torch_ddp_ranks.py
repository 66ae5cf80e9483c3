"""Rank functions of the port's data-parallel tests (test_torch_ddp*.py).

parallel.launch spawns one process per rank, and each imports the module
of the function it runs: this one imports torch and cim_tpu_torch alone
(no JAX, no cim_tpu), so that a rank starts in a few seconds. Each
function takes the rank's device first and returns what the test checks.
"""
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.algorithms.ddp_comm_hooks import default_hooks

from cim_tpu_torch import parallel
from cim_tpu_torch.engine.train import Trainer


def _trainer(cfg, device, init):
    trainer = Trainer(cfg, device=device, seed=0)
    trainer.load_weights(init)
    return trainer


def _rows(batch, row):
    return {k: v[row] for k, v in batch.items()}


def _params(trainer):
    return {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


def train_scenarios(device, cfg, init, batches):
    """Each rank, from the weights ``init``:
    - "rows": a step on row ``rank`` of each (ranks, accum, ...) batch;
    - "same": the same steps on row 0 of each batch, on every rank;
    returning each run's metrics and parameters; "passes": the gradient
    reductions (DDP comm-hook calls on the last bucket) of 2 steps at
    GRAD_ACCUM 1 and 2; "bucket_views": whether every gradient of a third
    step at GRAD_ACCUM 2 accumulated where the second step left it (in
    DDP's bucket), microbatch 0's under no_sync() included; "seeds":
    the anti-noise seeds of a step's 2 microbatches."""
    rank = parallel.rank()
    out = {}
    for name, row in (("rows", rank), ("same", 0)):
        trainer = _trainer(cfg, device, init)
        metrics = [trainer.step(_rows(b, row)) for b in batches]
        out[name] = {"metrics": metrics, "params": _params(trainer)}
    out["passes"] = {}
    for accum in (1, 2):
        trainer = _trainer(cfg, device, init)
        passes = []

        def hook(state, bucket):
            passes.append(bucket.is_last())
            return default_hooks.allreduce_hook(None, bucket)

        trainer.ddp.register_comm_hook(None, hook)
        for b in batches:
            trainer.step({k: v[rank, :accum] for k, v in b.items()})
        out["passes"][accum] = {"last": sum(passes), "buckets": len(passes)}
    out["seeds"] = [trainer.mining_seed(i) for i in range(2)]
    out["bucket_views"] = _accumulates_in_place(trainer, {k: v[rank] for k, v in batches[0].items()})
    out["world"] = parallel.world_size()
    out["threads"] = torch.get_num_threads()
    return out


def _accumulates_in_place(trainer, batch):
    """Whether each accumulation of a step lands in the gradient tensor
    the previous step left (DDP rebuilds its buckets once, after the first
    step, so the trainer must have taken one)."""
    params = [p for _, p in trainer.optimizer.params]
    before = {p: p.grad.data_ptr() for p in params}
    seen = []
    handles = [p.register_post_accumulate_grad_hook(
        lambda p: seen.append(p.grad.data_ptr() == before[p])) for p in params]
    trainer.step(batch)
    for h in handles:
        h.remove()
    return len(seen) == len(batch["labels"]) * len(params) and all(seen)


def fail_on_rank1(device):
    """Rank 1 raises at once; rank 0 would sleep for 5 minutes."""
    if parallel.rank() == 1:
        raise ValueError("rank 1 fails")
    time.sleep(300)
    return np.zeros(1)


def fail_on_both_ranks(device):
    """Both ranks pass the group's barrier, then each raises its own
    error: rank 1 at once, rank 0 after a second."""
    dist.barrier()
    if parallel.rank() == 0:
        time.sleep(1)
    raise RuntimeError(f"rank {parallel.rank()} fails after init")


def stall_on_rank1(device):
    """Rank 0 waits at an all-reduce that rank 1, asleep for 5 minutes,
    never joins."""
    if parallel.rank() == 1:
        time.sleep(300)
    dist.all_reduce(torch.zeros(1))
    return np.zeros(1)


def rank_and_device(device):
    return parallel.rank(), parallel.world_size(), str(device), torch.get_num_threads()
