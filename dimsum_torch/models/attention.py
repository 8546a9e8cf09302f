"""Self-attention (DiT blocks) and the bidirectional CrossAttentionFusion of
the combined block: port of `dimsum_tpu/models/attention.py`.

Heads split as (B, L, H, Dh) from contiguous q/k/v channel blocks, as in the
JAX package.  At the sequence lengths of this slice (L = 256) the JAX
package calls XLA's attention, not a Pallas kernel, so the port calls
`F.scaled_dot_product_attention`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from dimsum_torch.models.linear import Linear


def _sdpa(q, k, v):
    """q, k, v: (B, L, H, Dh) -> (B, L, H, Dh), softmax scale Dh**-0.5."""
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return out.transpose(1, 2)


def _heads(qkv, i: int, width: int, num_heads: int):
    B, L, _ = qkv.shape
    return qkv[..., i * width:(i + 1) * width].reshape(
        B, L, num_heads, width // num_heads)


class Attention(nn.Module):
    """timm `Attention`: qkv Linear, softmax attention, proj Linear."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x):
        B, L, D = x.shape
        qkv = self.qkv(x)
        q, k, v = (_heads(qkv, i, D, self.num_heads) for i in range(3))
        return self.proj(_sdpa(q, k, v).reshape(B, L, D))


class CrossAttentionFusion(nn.Module):
    """x1 attends to x2's keys/values and x2 to x1's (swap_k=False); the two
    results are concatenated and projected back to the full width `dim`."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        half = dim // 2
        self.num_heads = num_heads
        self.qkv1 = Linear(half, 3 * half, bias=qkv_bias, dtype=dtype)
        self.qkv2 = Linear(half, 3 * half, bias=qkv_bias, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x1, x2):
        B, N, C = x1.shape
        qkv1, qkv2 = self.qkv1(x1), self.qkv2(x2)
        q1, k1, v1 = (_heads(qkv1, i, C, self.num_heads) for i in range(3))
        q2, k2, v2 = (_heads(qkv2, i, C, self.num_heads) for i in range(3))
        x12 = _sdpa(q1, k2, v2).reshape(B, N, C)
        x21 = _sdpa(q2, k1, v1).reshape(B, N, C)
        return self.proj(torch.cat([x12, x21], dim=-1))
