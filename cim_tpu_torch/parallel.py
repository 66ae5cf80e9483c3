"""Splitting evaluation over processes (port of the host half of
cim_tpu/parallel/__init__.py: eval_index_range :37, merge_sharded_results
:48). The process index and count are arguments: the port has no
jax.process_index. Multi-GPU data parallelism is not ported yet.
"""
from __future__ import annotations


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
