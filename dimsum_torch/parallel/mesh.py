"""Process groups, port of `dimsum_tpu/parallel/mesh.py`: the process
group of a multi-process run (`init_distributed`, :23), the groups of
sequence parallelism (`make_seq_mesh`, :87), and the all_gather the
sequence-parallel ops share.

`make_seq_group(data, seq)` splits the world of an initialized
`torch.distributed` process group as the JAX (data, seq) mesh does: rank
r = d * seq + s sits at data row d and sequence position s.  The caller
initializes the default group (its backend, address, world size and rank)
and hands `SeqGroups.seq` to `DiMConfig.seq_group`; the code takes any
process group (one rank a card with NCCL; several ranks on one card, or on
the CPU, with gloo).
"""

from __future__ import annotations

import datetime
from typing import List, NamedTuple, Optional

import torch
import torch.distributed as dist

__all__ = ["SeqGroups", "init_distributed", "make_seq_group", "all_gather"]


def init_distributed(coordinator: str = "localhost:29512",
                     num_processes: int = 1,
                     process_id: Optional[int] = None, device="cuda",
                     backend: Optional[str] = None,
                     timeout_s: float = 600.0) -> int:
    """Join the default process group of a run of `num_processes`
    processes (the JAX CLI's --num-processes, --process-id and
    --coordinator; the reference's init_process_group, train.py:145) and
    return this process's rank.  A single process joins nothing and gets
    rank 0.

    `coordinator` is host:port of rank 0's TCP store.  The backend is
    `backend` if given, else NCCL for a CUDA `device` (one rank a card)
    and gloo for the CPU; gloo also runs several ranks on one card, which
    NCCL refuses."""
    if num_processes <= 1:
        return 0
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id must be in [0, {num_processes}), "
                         f"got {process_id}")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return process_id


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
