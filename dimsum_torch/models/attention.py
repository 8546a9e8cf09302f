"""Self-attention (DiT blocks) and the bidirectional CrossAttentionFusion of
the combined block: port of `dimsum_tpu/models/attention.py`.

Heads split as (B, L, H, Dh) from contiguous q/k/v channel blocks, as in the
JAX package.  The attention follows the JAX `_sdpa` (attention.py:35-54):
in its default mode, at L >= 1024 (L % 128 == 0, Dh >= 64, and the
full-block gate) the full-block attention of `ops/full_attention.py`, which
is the hand-written kernel on the card; at every shorter sequence (all of
256 px, where the JAX package calls XLA's attention and no Pallas kernel)
`F.scaled_dot_product_attention`.

The JAX switches are the modules' attributes `flash_attn` and `full_attn`
(the model's `DiMConfig` / `DiTConfig` fields, from DIMSUM_FLASH_ATTN and
DIMSUM_FULL_ATTN): "1", "0" or "auto".  They route by the JAX rule
(`takes_full_block`): the flash path is wanted where DIMSUM_FLASH_ATTN is
"1", or at L >= 1024 unless it is "0"; within it (L % 128 == 0, Dh >= 64)
the full-block kernel is preferred where DIMSUM_FULL_ATTN is "1", or unless
it is "0" or DIMSUM_FLASH_ATTN names the flash kernel ("1"), and taken
where `full_block_supported` holds.  The JAX flash path is the library
kernel `jax.experimental.pallas.ops.tpu.flash_attention`, no kernel of the
JAX package; its counterpart here is SDPA (PyTorch's own flash kernel on
the card), which also takes every other case.  (JAX takes its kernels only
on the TPU backend; on the CPU the JAX model always runs XLA's attention.)

With `tp_group` the heads are split over the group (`qkv`, `qkv1`, `qkv2`
column-parallel, each of q, k and v cut by head): each rank attends with
its heads, the heads are all-gathered (`tp_gather`) and the projection,
which the JAX rules leave whole, runs on every rank.
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
from dimsum_torch.parallel.mesh import tp_copy, tp_gather, tp_size
from dimsum_torch.utils import remat


def takes_full_block(L: int, Dh: int, flash: str = "auto",
                     full: str = "auto") -> bool:
    """The JAX route to the full-block kernel (attention.py:35-54) under
    DIMSUM_FLASH_ATTN = `flash` and DIMSUM_FULL_ATTN = `full`; by default
    L >= 1024 with L % 128 == 0 and Dh >= 64, where
    `full_block_supported` holds."""
    want = flash == "1" or (flash not in ("0", "1") and L >= 1024)
    prefer_full = full == "1" or (full != "0" and flash != "1")
    return (want and L % 128 == 0 and Dh >= 64 and prefer_full
            and full_block_supported(L, Dh))


def _sdpa(q, k, v, impl: Optional[str] = None, flash: str = "auto",
          full: str = "auto"):
    """q, k, v: (B, L, H, Dh) -> (B, L, H, Dh), softmax scale Dh**-0.5.
    `impl` "ref" takes the full-block attention's plain version where the
    kernel would run (elsewhere it changes nothing); `flash`, `full` the
    JAX switches (`takes_full_block`)."""
    if impl not in (None, "ref"):
        raise ValueError(f"unknown attention impl {impl!r}")
    L, Dh = q.shape[1], q.shape[3]
    if takes_full_block(L, Dh, flash, full):
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


def _local_heads(num_heads: int, group) -> int:
    k = tp_size(group)
    if num_heads % k:
        raise ValueError(f"{num_heads} heads do not split over {k} "
                         "tensor-parallel ranks")
    return num_heads // k


class _Routed(nn.Module):
    """The attributes both attentions share: `attn_impl` picks the
    attention at the full-block shapes (None, the kernel for CUDA tensors
    and the plain version for CPU tensors; "ref", the plain version on any
    device, which checks hold the kernel against); `flash_attn` and
    `full_attn` are the JAX switches (`takes_full_block`)."""

    def __init__(self):
        super().__init__()
        self.attn_impl: Optional[str] = None
        self.flash_attn = self.full_attn = "auto"

    def _attend(self, q, k, v):
        return _sdpa(q, k, v, self.attn_impl, self.flash_attn,
                     self.full_attn)


class Attention(_Routed):
    """timm `Attention`: qkv Linear, softmax attention, proj Linear."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.float32, tp_group=None):
        super().__init__()
        self.num_heads = num_heads
        self.tp_group = tp_group
        self.local_heads = _local_heads(num_heads, tp_group)
        width = dim * self.local_heads // num_heads
        self.qkv = Linear(dim, 3 * width, bias=qkv_bias, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x):
        B, L, D = x.shape
        qkv = self.qkv(tp_copy(x, self.tp_group))
        w = qkv.shape[-1] // 3
        q, k, v = (_heads(qkv, i, w, self.local_heads) for i in range(3))
        out = self._attend(q, k, v).reshape(B, L, w)
        return self.proj(tp_gather(out, self.tp_group))


class CrossAttentionFusion(_Routed):
    """x1 attends to x2's keys/values and x2 to x1's (swap_k=False); the two
    results are concatenated and projected back to the full width `dim`."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 dtype: torch.dtype = torch.float32, tp_group=None):
        super().__init__()
        half = dim // 2
        self.num_heads = num_heads
        self.tp_group = tp_group
        self.local_heads = _local_heads(num_heads, tp_group)
        width = half * self.local_heads // num_heads
        self.qkv1 = Linear(half, 3 * width, bias=qkv_bias, dtype=dtype)
        self.qkv2 = Linear(half, 3 * width, bias=qkv_bias, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x1, x2):
        B, N, _ = x1.shape
        g = self.tp_group
        qkv1, qkv2 = self.qkv1(tp_copy(x1, g)), self.qkv2(tp_copy(x2, g))
        w, h = qkv1.shape[-1] // 3, self.local_heads
        q1, k1, v1 = (_heads(qkv1, i, w, h) for i in range(3))
        q2, k2, v2 = (_heads(qkv2, i, w, h) for i in range(3))
        x12 = tp_gather(self._attend(q1, k2, v2).reshape(B, N, w), g)
        x21 = tp_gather(self._attend(q2, k1, v1).reshape(B, N, w), g)
        return self.proj(torch.cat([x12, x21], dim=-1))
