"""Data parallelism over processes, and splitting evaluation over
processes (port of cim_tpu/parallel/__init__.py).

cim_tpu trains data-parallel with one shard_map over a "dp" mesh axis and
a pmean of the summed gradients (cim_tpu/engine/train.py:218-288). The
port runs one process per rank in a torch.distributed group: NCCL between
cards, gloo on the CPU. engine.train.Trainer wraps its model in
DistributedDataParallel whenever a group exists; without one it is the
single-device trainer.

launch() starts the ranks. Under torchrun (WORLD_SIZE in the environment)
this process joins the group as its RANK. Otherwise a world of more than
one rank is spawned here, one process per rank
(torch.multiprocessing.spawn), and the ranks meet through a file store in
a fresh temporary directory, so that concurrent runs on one host cannot
collide on a port. A rank of a cuda run drives cuda:LOCAL_RANK unless the
caller names a card. Spawned ranks meet at a barrier after joining the
group and again before leaving it, so that no rank tears its group down
while a peer is still connecting. A spawned rank that raises writes its
traceback beside the results; the others get SPAWN_GRACE_S seconds to
end (a peer at a collective with it fails too) before they are
terminated, and launch raises with every rank's traceback. Under
torchrun, its agent ends the ranks. The group's timeout bounds how long a rank
waits for the others at a collective. Real runs keep torch's default:
rank 0 writes a ~2 GB snapshot while the others wait at a barrier, and
the ranks' own work between two collectives (a roidb load, a trace
export) may take minutes on a slow file system. Tests pass a short one,
so that a rank that stalls fails them within a minute.

Evaluation splits over processes with the reference's contiguous --range
shards (eval_index_range) and merges their pickles in the parent.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

# seconds the other spawned ranks get to end by themselves after one fails
SPAWN_GRACE_S = 5.0


def init(world: int, rank: int, device, backend: str | None = None,
         init_method: str | None = None, timeout: timedelta | None = None):
    """Join a process group of ``world`` ranks as ``rank``. The backend
    defaults to NCCL on cuda and gloo on the CPU; two ranks on one card
    need backend="gloo" (NCCL refuses a duplicate GPU). init_method
    defaults to env:// (torchrun's MASTER_ADDR and MASTER_PORT); timeout
    to torch's default."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world, rank=rank, **kwargs)


def destroy():
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier():
    """Wait for every rank of the group; nothing without a group."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def rank_device(device, local_rank: int) -> torch.device:
    """The device of a rank: cuda:LOCAL_RANK for "cuda", the card named
    otherwise (cuda:0 for two ranks on one card), the CPU for "cpu"."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank)
    return device


def host_shard_roidb(roidb, rank: int, world: int):
    """The disjoint, strided roidb shard of ``rank`` (cim_tpu
    host_shard_roidb, parallel/__init__.py:84): strides keep the aspect
    grouping of roidb.rank_for_training, and the shards cover the roidb."""
    return roidb[rank::world]


def _spawned(index, fn, args, world, device, backend, timeout, store, out_dir):
    try:
        # the host's cores shared between the ranks (torchrun gives each one)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        init(world, index, rank_device(device, index), backend, f"file://{store}", timeout)
        barrier()
        result = fn(rank_device(device, index), *args)
        torch.save(result, os.path.join(out_dir, f"rank{index}.pt"))
        barrier()
    except Exception:
        with open(os.path.join(out_dir, f"rank{index}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        destroy()


def _rank_errors(out_dir, world: int) -> str:
    """The tracebacks that spawned ranks wrote, each under its rank."""
    parts = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                parts.append(f"--- rank {r} ---\n{f.read()}")
    return "\n".join(parts)


def launch(fn, world: int, device="cuda", args=(), backend: str | None = None,
           timeout: timedelta | None = None) -> dict:
    """Run ``fn(rank_device, *args)`` on every rank of a group of ``world``
    and return {rank: result} of the ranks this process ran or spawned:
    all of them when it spawned them (results travel through torch.save,
    so they must pickle), its own under torchrun. A world of one outside
    torchrun runs fn here, without a group. A spawned rank that fails
    makes launch raise RuntimeError with the traceback of every rank that
    failed."""
    if "WORLD_SIZE" in os.environ:  # torchrun
        env_world, env_rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        if env_world != world:
            raise ValueError(f"torchrun started {env_world} ranks, the run asks for {world}")
        dev = rank_device(device, int(os.environ.get("LOCAL_RANK", env_rank)))
        init(world, env_rank, dev, backend, timeout=timeout)
        try:
            return {env_rank: fn(dev, *args)}
        finally:
            destroy()
    if world == 1:
        return {0: fn(torch.device(device), *args)}
    import torch.multiprocessing as mp

    out_dir = tempfile.mkdtemp(prefix="cim_ranks_")
    try:
        context = mp.spawn(_spawned, nprocs=world, join=False,
                           args=(fn, args, world, str(device), backend, timeout,
                                 os.path.join(out_dir, "store"), out_dir))
        try:
            while not context.join(grace_period=SPAWN_GRACE_S):
                pass
        except Exception as exc:
            errors = _rank_errors(out_dir, world) or "(no rank wrote a traceback)"
            raise RuntimeError(f"{exc}\nerrors of the failed ranks:\n{errors}") from exc
        return {r: torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(world)}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def eval_index_range(num_items: int, process_index: int, process_count: int):
    """[start, end) of process ``process_index`` of ``process_count`` over
    [0, num_items): contiguous ranges of near-equal length (the reference's
    --range start end subprocess contract, lib/utils/subprocess.py:41-145)."""
    return (process_index * num_items // process_count,
            (process_index + 1) * num_items // process_count)


def merge_sharded_results(results_per_shard: list) -> dict:
    """Merge per-shard {image: record} dicts (the reference merges pickled
    range files, lib/core/test_engine.py:174-186)."""
    merged = {}
    for shard in results_per_shard:
        merged.update(shard)
    return merged
