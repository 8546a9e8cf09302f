"""Self-attention (DiT blocks) and the bidirectional CrossAttentionFusion of
the combined block: port of `dimsum_tpu/models/attention.py`.

Heads split as (B, L, H, Dh) from contiguous q/k/v channel blocks, as in the
JAX package.  The attention follows the JAX `_sdpa` in its default mode
(attention.py:35-54): at L >= 1024 (L % 128 == 0, Dh >= 64, and the
full-block gate) the full-block attention of `ops/full_attention.py`, which
is the hand-written kernel on the card; at every shorter sequence (all of
256 px, where the JAX package calls XLA's attention and no Pallas kernel)
`F.scaled_dot_product_attention`.  The JAX ablation switches
(DIMSUM_FLASH_ATTN, DIMSUM_FULL_ATTN, DIMSUM_FULL_ATTN_QB) are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dimsum_torch.models.linear import Linear
from dimsum_torch.ops.full_attention import (full_attention_ref,
                                             full_block_attention,
                                             full_block_supported)
from dimsum_torch.utils import remat


def takes_full_block(L: int, Dh: int) -> bool:
    """The JAX default route to the full-block kernel: L >= 1024 with
    L % 128 == 0 and Dh >= 64, where `full_block_supported` holds."""
    return (L >= 1024 and L % 128 == 0 and Dh >= 64
            and full_block_supported(L, Dh))


def _sdpa(q, k, v, impl: Optional[str] = None):
    """q, k, v: (B, L, H, Dh) -> (B, L, H, Dh), softmax scale Dh**-0.5.
    `impl` "ref" takes the full-block attention's plain version where the
    kernel would run (elsewhere it changes nothing)."""
    if impl not in (None, "ref"):
        raise ValueError(f"unknown attention impl {impl!r}")
    L, Dh = q.shape[1], q.shape[3]
    if takes_full_block(L, Dh):
        if impl != "ref":
            return full_block_attention(q, k, v, Dh ** -0.5)
        with remat.tag("attn_out"):  # a remat site, as the kernel's Function
            return full_attention_ref(q, k, v, Dh ** -0.5)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    with remat.tag("attn_out"):
        out = F.scaled_dot_product_attention(q, k, v)
    return out.transpose(1, 2)


def _heads(qkv, i: int, width: int, num_heads: int):
    B, L, _ = qkv.shape
    return qkv[..., i * width:(i + 1) * width].reshape(
        B, L, num_heads, width // num_heads)


class Attention(nn.Module):
    """timm `Attention`: qkv Linear, softmax attention, proj Linear.

    `attn_impl` (an attribute) picks the attention at the full-block
    shapes: None, the kernel for CUDA tensors and the plain version for
    CPU tensors; "ref", the plain version on any device, which checks hold
    the kernel against."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.attn_impl: Optional[str] = None
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x):
        B, L, D = x.shape
        qkv = self.qkv(x)
        q, k, v = (_heads(qkv, i, D, self.num_heads) for i in range(3))
        return self.proj(_sdpa(q, k, v, self.attn_impl).reshape(B, L, D))


class CrossAttentionFusion(nn.Module):
    """x1 attends to x2's keys/values and x2 to x1's (swap_k=False); the two
    results are concatenated and projected back to the full width `dim`.
    `attn_impl` as in `Attention`."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        half = dim // 2
        self.num_heads = num_heads
        self.attn_impl: Optional[str] = None
        self.qkv1 = Linear(half, 3 * half, bias=qkv_bias, dtype=dtype)
        self.qkv2 = Linear(half, 3 * half, bias=qkv_bias, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x1, x2):
        B, N, C = x1.shape
        qkv1, qkv2 = self.qkv1(x1), self.qkv2(x2)
        q1, k1, v1 = (_heads(qkv1, i, C, self.num_heads) for i in range(3))
        q2, k2, v2 = (_heads(qkv2, i, C, self.num_heads) for i in range(3))
        x12 = _sdpa(q1, k2, v2, self.attn_impl).reshape(B, N, C)
        x21 = _sdpa(q2, k1, v1, self.attn_impl).reshape(B, N, C)
        return self.proj(torch.cat([x12, x21], dim=-1))
