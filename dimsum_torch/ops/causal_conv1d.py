"""Depthwise causal 1-D convolution with optional fused SiLU, PyTorch port of
`dimsum_tpu/ops/causal_conv1d.py`.  Layout (batch, L, dim).

`causal_conv1d_halo` is the sequence-sharded conv of sequence parallelism:
each rank of a process group holds one L-shard, in rank order.
`causal_conv1d_update` is the one-token decode step (plain jnp in JAX,
plain PyTorch here)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dimsum_torch.parallel.mesh import all_gather

__all__ = ["causal_conv1d", "causal_conv1d_halo", "causal_conv1d_update"]


def causal_conv1d(x, weight, bias=None, activation: str | None = "silu",
                  reverse: bool = False):
    """x: (B, L, D); weight: (D, W); bias: (D,).  Returns (B, L, D) in x's
    dtype, computed in fp32.

    y[b, t, d] = sum_k weight[d, k] * x[b, t - (W-1) + k, d]   (zero padded)

    With `reverse=True` the conv is anti-causal, equal to
    flip(causal_conv1d(flip(x))) with the products summed in the same order."""
    if activation not in (None, "silu", "swish"):
        raise NotImplementedError(f"activation {activation}")
    L = x.shape[1]
    W = weight.shape[1]
    xf = x.float()
    wf = weight.float()
    pad = (0, 0, 0, W - 1) if reverse else (0, 0, W - 1, 0)
    xp = F.pad(xf, pad)
    y = torch.zeros_like(xf)
    for k in range(W):
        o = (W - 1 - k) if reverse else k
        y = y + xp[:, o:o + L, :] * wf[:, k]
    if bias is not None:
        y = y + bias.float()
    if activation in ("silu", "swish"):
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def causal_conv1d_halo(x, weight, bias=None, activation: str | None = "silu",
                       group=None):
    """The conv of an L-shard x (B, L_shard, D) of a sequence split over
    the ranks of `group` in rank order: each rank takes the previous
    rank's last W-1 tokens as a left halo, rank 0 zeros (the unsharded
    zero padding), so the shards' results are the unsharded
    `causal_conv1d`'s (the JAX `causal_conv1d_halo`, causal_conv1d.py:60).
    The halos travel as one all_gather of (B, W-1, D) from every rank (a
    ring of sends would need send/recv, which not every backend takes for
    CUDA tensors).  Raises when the shard is shorter than W-1."""
    W = weight.shape[1]
    if x.shape[1] < W - 1:
        raise ValueError(
            f"causal_conv1d_halo: per-shard seqlen {x.shape[1]} is shorter "
            f"than the conv halo width {W - 1}; a one-hop halo exchange "
            f"would diverge from the unsharded conv -- use fewer sequence "
            f"shards")
    if W == 1:
        return causal_conv1d(x, weight, bias, activation)
    halos = all_gather(x[:, x.shape[1] - (W - 1):], group)
    my = torch.distributed.get_rank(group)
    prev = halos[my - 1] if my > 0 else torch.zeros_like(halos[0])
    xp = torch.cat([prev, x], dim=1)
    return causal_conv1d(xp, weight, bias, activation)[:, W - 1:].contiguous()


def causal_conv1d_update(x, conv_state, weight, bias=None,
                         activation: str | None = "silu"):
    """One decode step (the JAX `causal_conv1d_update`, reference
    causal_conv1d_update.cu:26-66): x (B, D) the new token, conv_state
    (B, W, D) the last W inputs.  The state shifts by one and takes x; y
    = sum_w state[:, w] weight[:, w] (+ bias, SiLU) in fp32.  Returns (y
    in x's dtype, the new state in conv_state's dtype)."""
    if activation not in (None, "silu", "swish"):
        raise NotImplementedError(f"activation {activation}")
    new_state = torch.cat([conv_state[:, 1:], x[:, None].to(conv_state.dtype)],
                          dim=1)
    y = torch.einsum("bwd,dw->bd", new_state.float(), weight.float())
    if bias is not None:
        y = y + bias.float()
    if activation in ("silu", "swish"):
        y = y * torch.sigmoid(y)
    return y.to(x.dtype), new_state
