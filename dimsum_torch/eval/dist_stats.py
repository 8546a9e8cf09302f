"""Combining metric feature statistics across processes, port of
`dimsum_tpu/eval/dist_stats.py`.

Each process accumulates a `FeatureStats` over its own CONTIGUOUS slice of
the work (the samples it generated, its shard of the real dataset); one
`all_gather_object` over the default `torch.distributed` process group
(`dimsum_torch.parallel.init_distributed`) combines them.  The moments add
and the raw features concatenate in rank order, so contiguous slices in
rank order give the one-process item order exactly: KID's subsets and
precision/recall see the same inputs as a one-process run.
"""

from __future__ import annotations

from typing import List

import torch.distributed as dist

from dimsum_torch.eval.fid import FeatureStats

__all__ = ["world", "combine_feature_stats", "merge_feature_stats"]


def world():
    """(rank, world size) of the default process group, (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def merge_feature_stats(parts: List[FeatureStats]) -> FeatureStats:
    """Merge partial FeatureStats (one a contiguous slice, in slice
    order): moments add, raw features concatenate."""
    out = FeatureStats(
        capture_all=any(p.capture_all for p in parts),
        capture_mean_cov=all(p.capture_mean_cov for p in parts))
    for p in parts:
        if p.num_items == 0:
            continue
        out.set_num_features(p.num_features)
        out.num_items += int(p.num_items)
        if out.capture_mean_cov:
            out.raw_mean += p.raw_mean
            out.raw_cov += p.raw_cov
        if out.capture_all:
            out.all_features.append(p.get_all())
    return out


def combine_feature_stats(stats: FeatureStats) -> FeatureStats:
    """Every process's partial FeatureStats combined into the global ones.
    Collective: every process of the default group calls it, and every
    process returns the same combined object.  One process: identity."""
    if world()[1] == 1:
        return stats
    state = dict(
        num_items=stats.num_items,
        raw_mean=stats.raw_mean, raw_cov=stats.raw_cov,
        all_features=(stats.get_all() if stats.capture_all
                      and stats.num_items > 0 else None))
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, state)
    parts = []
    for d in gathered:  # rank order == contiguous-slice order
        p = FeatureStats(capture_all=stats.capture_all,
                         capture_mean_cov=stats.capture_mean_cov)
        if d["num_items"]:
            p.set_num_features(d["raw_mean"].shape[0])
            p.num_items = int(d["num_items"])
            p.raw_mean, p.raw_cov = d["raw_mean"], d["raw_cov"]
            if p.capture_all and d["all_features"] is not None:
                p.all_features = [d["all_features"]]
        parts.append(p)
    return merge_feature_stats(parts)
