"""Expert parallelism for the MoE FFN, port of
`dimsum_tpu/parallel/moe_ep.py`: top-1 routing with Switch-Transformer
capacity dispatch (`_dispatch_top1`, :56-76), the experts split over the
model group (`switch_ep_gspmd`, :78-121), and `stack_expert_params`
(:123-143).

The JAX package turns this route on whenever `--tp > 1` and `--is-moe`
(train.py:158-159; dim.py:68-70, :214-224; blocks.py:629-672): the
experts live stacked and sharded over the mesh's model axis, every token
goes to its argmax expert's bucket of `capacity = ceil(T * capacity_factor
/ E)` slots in token order, and a token past its expert's capacity is
dropped: the FFN adds nothing for it, and it passes through the residual.
Within a model group the tokens are replicated, so here each rank runs
its own E / k experts (`SwitchMLP.local_experts`, keyed by their global
index) on their buckets, and the combined outputs are summed over the
group (`parallel/mesh.py::tp_sum`) before the routing probability scales
them.  A bucket is the kept tokens gathered by index, which equals the
JAX one-hot product (one term of each sum is nonzero).  The experts
compute in fp32, as the JAX einsums promote the tokens to the stacked
fp32 weights; the dense single-device route (`SwitchMLP` without a group)
runs every expert on every token instead, and equals this one wherever no
token is dropped.

Positions in a bucket are counted in int64: the JAX one-hot cumsum counts
them in the tokens' dtype, which in bf16 is exact only up to 256 tokens an
expert.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from dimsum_torch.parallel.mesh import tp_copy, tp_sum

__all__ = ["capacity", "dispatch_top1", "switch_ep", "stack_expert_params"]


def capacity(tokens: int, num_experts: int, capacity_factor: float) -> int:
    """Slots an expert: max(1, ceil(T * capacity_factor / E))."""
    return max(1, int(math.ceil(tokens * capacity_factor / num_experts)))


def dispatch_top1(logits: torch.Tensor, cap: int,
                  routing_mode: str = "top1"):
    """Top-1 capacity dispatch over (T, E) router logits (the JAX
    `_dispatch_top1`): the route's probabilities (sigmoid for "sinkhorn",
    else softmax), each token's argmax expert and its top probability, and
    whether it is kept (its 1-based position among its expert's tokens, in
    token order, at most `cap`).  Returns (max_prob (T,), expert (T,),
    keep (T,) bool)."""
    route = (torch.sigmoid(logits) if routing_mode == "sinkhorn"
             else torch.softmax(logits, dim=-1))
    max_prob, expert = route.max(dim=-1)
    onehot = F.one_hot(expert, logits.shape[-1])
    pos = (onehot.cumsum(0) * onehot).sum(-1)
    return max_prob, expert, pos <= cap


def _expert_ffn(mlp, x):
    """One expert's FFN on its bucket in fp32 (the JAX `_expert_ffn` over
    stacked fp32 weights): linear_fc1, GLU or exact GELU, linear_fc2."""
    def lin(layer, v):
        b = None if layer.bias is None else layer.bias.float()
        return F.linear(v, layer.weight.float(), b)

    h = lin(mlp.linear_fc1, x.float())
    if mlp.gated_linear_unit:
        a, b = h.chunk(2, dim=-1)
        h = F.gelu(a) * b
    else:
        h = F.gelu(h)
    return lin(mlp.linear_fc2, h)


def switch_ep(x: torch.Tensor, logits: torch.Tensor,
              experts: Mapping[int, torch.nn.Module], num_experts: int,
              group=None, capacity_factor: float = 2.0,
              routing_mode: str = "top1") -> torch.Tensor:
    """The expert-parallel MoE FFN (the JAX `switch_ep_gspmd`): x (B, L, D)
    tokens, the same on every rank of `group`; logits (B, L, E); `experts`
    this rank's experts by global index (all of them when `group` is None,
    the JAX `mesh=None` route).  Returns the fp32 (B, L, D) output."""
    B, L, D = x.shape
    T = B * L
    cap = capacity(T, num_experts, capacity_factor)
    max_prob, expert, keep = dispatch_top1(logits.reshape(T, num_experts),
                                           cap, routing_mode)
    xf = tp_copy(x, group).reshape(T, D)
    combined = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for e, mlp in experts.items():
        rows = torch.nonzero(keep & (expert == e)).squeeze(1)
        combined = combined.index_add(0, rows, _expert_ffn(mlp, xf[rows]))
    combined = tp_sum(combined, group)
    return (combined * max_prob[:, None]).reshape(B, L, D)


def stack_expert_params(state_dict: Mapping[str, torch.Tensor],
                        prefix: str = "") -> Dict[str, torch.Tensor]:
    """The dense experts' weights (`<prefix>local_experts.<e>.linear_fc1` /
    `linear_fc2`, torch layout) stacked in the JAX layout the EP route
    consumes (the JAX `stack_expert_params`): w1 (E, D, H'), w2 (E, H, D),
    and b1 (E, H'), b2 (E, D) where the experts have biases."""
    idx = sorted({int(k[len(prefix):].split(".")[1])
                  for k in state_dict
                  if k.startswith(prefix + "local_experts.")})

    def stack(layer: str, leaf: str) -> Optional[torch.Tensor]:
        keys = [f"{prefix}local_experts.{i}.{layer}.{leaf}" for i in idx]
        if keys[0] not in state_dict:
            return None
        ts = [state_dict[k] for k in keys]
        return torch.stack([t.t() if leaf == "weight" else t for t in ts])

    out = {"w1": stack("linear_fc1", "weight"),
           "w2": stack("linear_fc2", "weight")}
    b1 = stack("linear_fc1", "bias")
    if b1 is not None:
        out["b1"] = b1
        out["b2"] = stack("linear_fc2", "bias")
    return out
