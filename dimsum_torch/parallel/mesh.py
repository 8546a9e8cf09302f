"""Process groups for sequence parallelism, port of
`dimsum_tpu/parallel/mesh.py::make_seq_mesh` (:87), and the all_gather the
sequence-parallel ops share.

`make_seq_group(data, seq)` splits the world of an initialized
`torch.distributed` process group as the JAX (data, seq) mesh does: rank
r = d * seq + s sits at data row d and sequence position s.  The caller
initializes the default group (its backend, address, world size and rank)
and hands `SeqGroups.seq` to `DiMConfig.seq_group`; the code takes any
process group and never picks the backend itself (one rank a card with
NCCL; several ranks on one card, or on the CPU, with gloo).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch
import torch.distributed as dist

__all__ = ["SeqGroups", "make_seq_group", "all_gather"]


class SeqGroups(NamedTuple):
    data: dist.ProcessGroup  # this rank's data row's peers: same s
    seq: dist.ProcessGroup   # this rank's sequence shards: same d


def make_seq_group(data: int = 1, seq: Optional[int] = None) -> SeqGroups:
    """The (data, seq) split of the default group's world: `data` rows of
    `seq` ranks each (seq=None: world // data).  Every rank must call it,
    in the same order as its other group creations.  Returns this rank's
    data and seq groups."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if seq is None:
        seq = world // data
    if data * seq != world:
        raise ValueError(f"{data}x{seq} != {world} ranks")
    mine = {}
    for d in range(data):  # every rank creates every group, in one order
        g = dist.new_group(list(range(d * seq, (d + 1) * seq)))
        if rank // seq == d:
            mine["seq"] = g
    for s in range(seq):
        g = dist.new_group(list(range(s, world, seq)))
        if rank % seq == s:
            mine["data"] = g
    return SeqGroups(data=mine["data"], seq=mine["seq"])


def all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's `x` (one shape and dtype on all ranks), in the group's
    rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts
