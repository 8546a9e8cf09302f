"""Process groups, port of `dimsum_tpu/parallel/mesh.py`: the process
group of a multi-process run (`init_distributed`, :23), the groups of
sequence parallelism (`make_seq_mesh`, :87) and of the (data, model) mesh
(`make_mesh`, :75-84), the tensor-parallel rule table over the port's
state-dict names (`_TP_RULES` / `tp_param_specs`, :108-157) with the
functions that shard a full state dict into a rank's shards and gather it
back, and the collectives the parallel modules share.

`make_seq_group(data, seq)` splits the world of an initialized
`torch.distributed` process group as the JAX (data, seq) mesh does: rank
r = d * seq + s sits at data row d and sequence position s.
`make_mesh_groups(data, model)` does the same for (data, model): rank
r = d * model + m; its `model` group holds a data row's tensor-parallel
ranks, its `data` group the ranks of one model position, over which the
data-parallel step averages.  The caller initializes the default group (its
backend, address, world size and rank); the code takes any process group
(one rank a card with NCCL; several ranks on one card, or on the CPU, with
gloo).

Tensor parallelism (`DiMConfig.tp_group`) holds each rank's shard of the
parameters that `TP_RULES` names, under the reference's names at the shard's
shape, and every other parameter whole:

  * column-parallel weights (`in_proj`, `dt_proj`, `w12`, `qkv`, `qkv1`,
    `qkv2`; their biases with them) keep the rows of the rank's channels.
    A weight whose rows are a stack of parts (`in_proj` [x; z], `w12`
    [a; b], `qkv` [q; k; v]) is cut part by part, so that a rank holds the
    same channel range (or the same heads) of each part;
  * row-parallel weights (`x_proj`, `out_proj`, `w3`) keep the columns of
    the rank's channels, their products summed over the group;
  * per-channel parameters (`conv1d`, `A_log`, `D`, and their `_b` twins)
    keep the rank's channels;
  * the MoE experts (`local_experts.<e>`) are split by expert: rank m holds
    experts [m E / k, (m + 1) E / k), whole (expert parallelism, the JAX
    stacked `experts_fc*` rule).

`shard_state_dict` cuts a full state dict to a rank's, `gather_state_dict`
puts the group's shards back together (every rank gets the full dict, in the
full model's key order when given).  The checkpoints of a tensor-parallel
run hold the gathered dict, so they load at any `--tp` and into the JAX
package through `convert_torch_state_dict`.

The collectives (`tp_copy`, `tp_sum`, `tp_sum_sharded`, `tp_gather`) are
autograd Functions over plain local tensors: no kernel sees anything else.
Each sum is one all_reduce, whose result every rank gets alike (gloo and
NCCL both take it on CUDA tensors); the gathers are all_gathers.
"""

from __future__ import annotations

import datetime
import os
import re
from typing import (Dict, Iterable, List, Mapping, NamedTuple, Optional,
                    Sequence, Tuple)

import torch
import torch.distributed as dist

__all__ = ["SeqGroups", "MeshGroups", "init_distributed", "default_backend",
           "make_seq_group",
           "make_mesh_groups", "all_gather", "TP_RULES", "tp_rule",
           "tp_size", "tp_rank", "shard_tensor", "shard_state_dict",
           "gather_state_dict", "group_sum", "tp_copy", "tp_sum",
           "tp_sum_sharded",
           "tp_gather", "is_sharded"]


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
    `backend` if given, else `default_backend`."""
    if num_processes <= 1:
        return 0
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id must be in [0, {num_processes}), "
                         f"got {process_id}")
    if backend is None:
        backend = default_backend(device, num_processes)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return process_id


def default_backend(device, num_processes: int) -> str:
    """NCCL when each of this host's ranks has a card of its own, gloo on
    the CPU and when ranks share a card (NCCL takes one rank a card).  The
    host's ranks are LOCAL_WORLD_SIZE where a launcher sets it, else all
    `num_processes`."""
    if torch.device(device).type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


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


class MeshGroups(NamedTuple):
    data: dist.ProcessGroup   # the ranks of this model position (DP)
    model: dist.ProcessGroup  # this data row's tensor-parallel ranks
    data_index: int
    model_index: int
    data_ways: int
    model_ways: int


def make_mesh_groups(data: Optional[int] = None,
                     model: int = 1) -> MeshGroups:
    """The (data, model) split of the default group's world (the JAX
    `make_mesh`, mesh.py:75-84): `data` rows (None: world // model) of
    `model` ranks each, rank r at row r // model, position r % model.
    Every rank must call it, in the same order as its other group
    creations."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"{data}x{model} != {world} ranks")
    mine = {}
    for d in range(data):
        g = dist.new_group(list(range(d * model, (d + 1) * model)))
        if rank // model == d:
            mine["model"] = g
    for m in range(model):
        g = dist.new_group(list(range(m, world, model)))
        if rank % model == m:
            mine["data"] = g
    return MeshGroups(data=mine["data"], model=mine["model"],
                      data_index=rank // model, model_index=rank % model,
                      data_ways=data, model_ways=model)


# ---------------------------------------------------------------------------
# The tensor-parallel rule table over the port's state-dict names
# ---------------------------------------------------------------------------

# name regex -> (dim, parts): the axis a parameter is cut along and the
# parts stacked on it, each cut alike; the JAX `_TP_RULES` (mesh.py:112-
# 130) in torch layout (Linear weights are (out, in), so the JAX P(None,
# "model") of a kernel is dim 0 here and P("model", None) dim 1)
TP_RULES: Tuple[Tuple[str, Tuple[int, int]], ...] = (
    (r".*\.in_proj\.weight$", (0, 2)),
    (r".*\.(x_proj|x_proj_b|out_proj)\.weight$", (1, 1)),
    (r".*\.conv1d(_b)?\.(weight|bias)$", (0, 1)),
    (r".*\.dt_proj(_b)?\.(weight|bias)$", (0, 1)),
    (r".*\.A(_b)?_log$", (0, 1)),
    (r".*\.D(_b)?$", (0, 1)),
    (r".*\.w12\.(weight|bias)$", (0, 2)),
    (r".*\.w3\.weight$", (1, 1)),
    (r".*\.(qkv|qkv1|qkv2)\.(weight|bias)$", (0, 3)),
)
_EXPERT = re.compile(r"^((?:.*\.)?local_experts\.)(\d+)(\..*)$")


def tp_rule(name: str) -> Optional[Tuple[int, int]]:
    """(dim, parts) of a sharded parameter, None for a replicated one (the
    experts are split by expert, `shard_state_dict`)."""
    for pattern, rule in TP_RULES:
        if re.match(pattern, name):
            return rule
    return None


def is_sharded(name: str) -> bool:
    """Whether a parameter of a tensor-parallel model is a rank's own: a
    shard under `TP_RULES`, or an expert."""
    return tp_rule(name) is not None or _EXPERT.match(name) is not None


def tp_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def tp_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def shard_tensor(t: torch.Tensor, rule: Tuple[int, int], rank: int,
                 k: int) -> torch.Tensor:
    """Rank `rank`'s shard of `t` under `rule` (dim, parts): each part cut
    in k equal slices, the rank's slice of each, concatenated."""
    dim, parts = rule
    out = []
    for part in t.chunk(parts, dim):
        size = part.shape[dim] // k
        if size * k != part.shape[dim]:
            raise ValueError(f"a part of {part.shape[dim]} along dim {dim} "
                             f"does not split into {k} shards")
        out.append(part.narrow(dim, rank * size, size))
    return torch.cat(out, dim).contiguous()


def _num_experts(names: Iterable[str]) -> Dict[str, int]:
    """Experts per MoE layer (the prefix before `local_experts.`)."""
    count: Dict[str, int] = {}
    for name in names:
        m = _EXPERT.match(name)
        if m is not None:
            count[m.group(1)] = max(count.get(m.group(1), 0),
                                    int(m.group(2)) + 1)
    return count


def shard_state_dict(state_dict: Mapping[str, torch.Tensor], rank: int,
                     k: int) -> Dict[str, torch.Tensor]:
    """A full state dict cut to model rank `rank` of `k`: sharded
    parameters by `TP_RULES`, the experts by owner (rank m of k holds
    experts [m E / k, (m + 1) E / k)), the rest whole."""
    experts = _num_experts(state_dict)
    out = {}
    for name, t in state_dict.items():
        m = _EXPERT.match(name)
        if m is not None:
            e, per = int(m.group(2)), experts[m.group(1)] // k
            if experts[m.group(1)] % k:
                raise ValueError(f"{experts[m.group(1)]} experts do not "
                                 f"split over {k} ranks")
            if e // per == rank:
                out[name] = t
            continue
        rule = tp_rule(name)
        out[name] = t if rule is None else shard_tensor(t, rule, rank, k)
    return out


def gather_state_dict(state_dict: Mapping[str, torch.Tensor], group,
                      order: Optional[Sequence[str]] = None
                      ) -> Dict[str, torch.Tensor]:
    """The inverse of `shard_state_dict` over the model group: every rank
    gets the full dict (keys in `order` when given, e.g. the full model's
    `state_dict().keys()`).  Every rank must call it with its own shards,
    its dict's keys in the same order on every rank but the experts'."""
    k = tp_size(group)
    out = {}
    experts = [n for n in state_dict if _EXPERT.match(n)]
    for name, t in state_dict.items():
        if name in experts:
            continue
        rule = tp_rule(name)
        if rule is None or k == 1:
            out[name] = t
            continue
        dim, parts = rule
        shards = [p.chunk(parts, dim) for p in all_gather(t, group)]
        out[name] = torch.cat([shards[r][i] for i in range(parts)
                               for r in range(k)], dim)
    # rank r's j-th expert of a layer is the layer's expert r * per + j:
    # the ranks hold their experts in one order and shape
    local: Dict[str, List[int]] = {}
    for name in experts:
        prefix, e, _ = _EXPERT.match(name).groups()
        if int(e) not in local.setdefault(prefix, []):
            local[prefix].append(int(e))
    for name in experts:
        prefix, e, leaf = _EXPERT.match(name).groups()
        j, per = local[prefix].index(int(e)), len(local[prefix])
        pieces = all_gather(state_dict[name], group) if k > 1 else \
            [state_dict[name]]
        for r, piece in enumerate(pieces):
            out[f"{prefix}{r * per + j}{leaf}"] = piece
    if order is not None:
        missing = set(order) ^ set(out)
        if missing:
            raise ValueError(f"gathered keys differ from the order's: "
                             f"{sorted(missing)[:8]}")
        out = {n: out[n] for n in order}
    return out


# ---------------------------------------------------------------------------
# Collectives of the tensor-parallel modules (autograd Functions)
# ---------------------------------------------------------------------------

def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of x (a new tensor; one all_reduce, the same bits
    on every rank)."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return group_sum(g, ctx.group), None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, sharded_after):
        ctx.group, ctx.sharded_after = group, sharded_after
        return group_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        g = group_sum(g, ctx.group) if ctx.sharded_after else g
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return torch.cat(all_gather(x, group), dim)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.size, ctx.size).contiguous(), \
            None, None


def tp_copy(x, group):
    """x into a rank-local (column-parallel) computation: the identity
    forward; the backward sums the ranks' partial gradients."""
    return x if group is None else _Copy.apply(x, group)


def tp_sum(x, group):
    """The sum of the ranks' partial products (a row-parallel output)
    feeding computation that every rank repeats: the backward passes the
    (equal) gradient through."""
    return x if group is None else _Sum.apply(x, group, False)


def tp_sum_sharded(x, group):
    """The sum of the ranks' partial products feeding rank-local
    computation (x_proj's x_dbl, which each rank's channels read): the
    backward sums the ranks' gradients too."""
    return x if group is None else _Sum.apply(x, group, True)


def tp_gather(x, group, dim: int = -1):
    """The ranks' shards concatenated along `dim` in rank order (the
    attention's heads), feeding computation that every rank repeats: the
    backward keeps the rank's slice."""
    if group is None:
        return x
    return _Gather.apply(x, group, dim % x.ndim)
