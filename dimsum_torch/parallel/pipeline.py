"""Pipeline parallelism, port of `dimsum_tpu/parallel/pipeline.py`: the
GPipe microbatch schedule over a group of stage ranks (`pipeline_apply`,
:21-82) and the DiM forward with its block stack staged over them
(`dim_pipeline_forward`, :102-203).

Stage s of k holds blocks [s per, (s + 1) per) (per = depth / k) and the
shared attention block; the embedders and the final layer run on every
rank.  Step i of the m + k - 1 steps: stage 0 takes microbatch i (while
one remains), every other stage what the previous stage made in step
i - 1; the last stage banks microbatch i - k + 1; then the activations hop
one stage on.  A stage whose step holds no microbatch (the bubble) runs
nothing: its output is never read.  The residual stream starts as zeros
in the residual dtype (the sequential model's first block sees none; x +
0 is x), and the carried tuple is (hidden, residual, c).

The hop is an all_gather over the group (every stage takes the previous
stage's part), the lockstep counterpart of JAX's `ppermute`: gloo's
send / recv abort on CUDA tensors, and NCCL takes one rank a
card, so ranks that share a card go through gloo, which copies each CUDA
tensor through host memory.  At the end the last stage's outputs are
all_gathered to every rank (JAX's psum of the last stage's).

Constraints, checked as JAX asserts them (:129-140; here a ValueError
with the JAX message, `check_pipeline`): depth divisible by
the stages, a stage's block count divisible by 4 (the reverse / transpose
period) and by `use_attn_every_k_layers`, the shared attention block only,
no MoE, no auxiliary fourier blocks, no final norm, the "ape" position
embedding.  A deferred tail (`pending_tail`) is made at each block's end,
as the JAX stage templates build their blocks without it.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from dimsum_torch.models.blocks import materialize_pending
from dimsum_torch.parallel.mesh import all_gather

__all__ = ["pipeline_apply", "check_pipeline", "stage_blocks",
           "keep_stage_blocks_", "dim_pipeline_forward"]


def pipeline_apply(stage_fn: Callable, x: Sequence[torch.Tensor], group,
                   num_microbatches: int = 4) -> Tuple[torch.Tensor, ...]:
    """Run `stage_fn` (this rank's stage: a tuple of microbatch tensors to
    a tuple of the same shapes) over microbatches of `x` (a tuple of
    (B, ...) tensors, the same on every rank) on the stage ranks of
    `group`, rank s of the group being stage s.  Returns the full output
    batch on every rank."""
    k, s = dist.get_world_size(group), dist.get_rank(group)
    m = num_microbatches
    B = x[0].shape[0]
    assert B % m == 0, f"batch {B} does not split into {m} microbatches"
    xs = [a.reshape(m, B // m, *a.shape[1:]) for a in x]
    buf = tuple(torch.zeros_like(a[0]) for a in xs)
    outs = [torch.zeros_like(a) for a in xs]
    for i in range(m + k - 1):
        inp = tuple(a[i] for a in xs) if s == 0 and i < m else buf
        if 0 <= i - s < m:  # this stage holds microbatch i - s
            out = tuple(stage_fn(inp))
        else:
            out = tuple(torch.zeros_like(a) for a in buf)
        j = i - (k - 1)
        if s == k - 1 and 0 <= j < m:
            for acc, o in zip(outs, out):
                acc[j] = o
        if i + 1 < m + k - 1:
            buf = tuple(all_gather(o, group)[(s - 1) % k] for o in out)
    outs = [all_gather(a, group)[k - 1] for a in outs]
    return tuple(a.reshape(B, *a.shape[2:]) for a in outs)


def check_pipeline(cfg, k: int) -> int:
    """Raise ValueError where a DiM config cannot be staged over k stages
    (the JAX assertions); return the blocks a stage."""
    def need(ok, msg):
        if not ok:
            raise ValueError(msg)

    depth = cfg.eff_depth
    need(depth % k == 0, f"depth {depth} not divisible by {k} stages")
    per = depth // k
    need(per % 4 == 0,
         f"{per} blocks/stage breaks the i%4 reverse/transpose period -- "
         "use a stage count with depth/stages % 4 == 0")
    if cfg.use_attn_every_k_layers > 0:
        need(per % cfg.use_attn_every_k_layers == 0,
             "attention insertion period must divide the stage size")
        need(not cfg.use_independent_attn,
             "pipeline supports the shared attention block only")
    need(not cfg.is_moe and not cfg.enable_fourier_layers,
         "pipeline stages no MoE and no auxiliary fourier blocks")
    need(not cfg.use_final_norm and cfg.pe_type == "ape",
         "pipeline needs no final norm and the ape position embedding")
    return per


def stage_blocks(model, group) -> range:
    """The indices of the blocks this rank's stage holds."""
    k, s = dist.get_world_size(group), dist.get_rank(group)
    per = check_pipeline(model.cfg, k)
    return range(s * per, (s + 1) * per)


def keep_stage_blocks_(model, group):
    """Free the blocks of the other stages (each replaced by an empty
    placeholder, so that the indices stay); returns the model."""
    mine = set(stage_blocks(model, group))
    for i in range(len(model.blocks)):
        if i not in mine:
            model.blocks[i] = nn.Identity()
    return model


def dim_pipeline_forward(model, x, t, y, group,
                         num_microbatches: int = 4) -> torch.Tensor:
    """The DiM forward (inference) with its blocks pipelined over the stage
    ranks of `group` (the JAX `dim_pipeline_forward`): x (N, C, H, W), t
    (N,), y (N,) or None, the same on every rank.  `num_microbatches` is
    clamped to gcd(num_microbatches, N).  Returns (N, out_channels, H,
    W) on every rank."""
    cfg = model.cfg
    blocks = stage_blocks(model, group)
    h, c = model.embed(x, t, y)
    every = cfg.use_attn_every_k_layers
    residual0 = torch.zeros(h.shape, device=h.device, dtype=(
        torch.float32 if cfg.residual_in_fp32 else h.dtype))

    def stage_fn(mb):
        h_, r_, c_ = mb
        for j, i in enumerate(blocks):
            out = model.blocks[i](h_, r_, c_)
            h_, r_ = out[0], out[1]
            if len(out) == 3:  # the deferred tail, made at once
                h_ = materialize_pending(h_, out[2])
            if every > 0 and (j + 1) % every == 0:
                h_ = model.attn_block(h_, c_)
        return h_, r_, c_

    m = math.gcd(num_microbatches, x.shape[0]) or 1
    h, _, _ = pipeline_apply(stage_fn, (h, residual0, c), group, m)
    return model.final(h, c)
