"""Depthwise causal 1-D convolution with optional fused SiLU, PyTorch port of
`dimsum_tpu/ops/causal_conv1d.py`.  Layout (batch, L, dim)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["causal_conv1d"]


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
