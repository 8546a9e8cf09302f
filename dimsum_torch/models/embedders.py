"""Patch, timestep and label embedders, the sin-cos position table, the 2-D
rotary tables (`pe_type` "rope") and the conditional position CNN
(`AdaInPosCNN`, `pe_type` "cpe"), the final layer and unpatchify: port of
`dimsum_tpu/models/embedders.py`."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from dimsum_torch.models.linear import Linear
from dimsum_torch.ops.norms import layer_norm, modulate, norm_modulate


def _1d_sincos(embed_dim: int, pos: np.ndarray):
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """(grid_size**2, embed_dim) float32 table, w-coordinate half first."""
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0)
    grid = grid.reshape([2, 1, grid_size, grid_size])
    emb_h = _1d_sincos(embed_dim // 2, grid[0])
    emb_w = _1d_sincos(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)


def get_2d_sincos_rotary_embed(embed_dim: int, grid_size: int):
    """(emb_sin, emb_cos), each (grid_size**2, embed_dim) float32 (the JAX
    `get_2d_sincos_rotary_embed`, embedders.py:50-70): half the dims encode
    each axis, each frequency repeated twice for the interleaved pairs."""
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0).reshape(
        [2, 1, grid_size, grid_size])

    def one_axis(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        out = np.einsum("m,d->md", pos.reshape(-1), 1.0 / 10000 ** omega)
        return np.sin(out), np.cos(out)

    sin_h, cos_h = one_axis(embed_dim // 2, grid[0])
    sin_w, cos_w = one_axis(embed_dim // 2, grid[1])
    emb_sin = np.concatenate([sin_h, sin_w], axis=1).repeat(2, axis=1)
    emb_cos = np.concatenate([cos_h, cos_w], axis=1).repeat(2, axis=1)
    return emb_sin.astype(np.float32), emb_cos.astype(np.float32)


def rotate_half(x):
    """Interleaved rotate-half: (x0, x1, x2, x3, ...) -> (-x1, x0, -x3,
    x2, ...)."""
    pairs = x.unflatten(-1, (-1, 2))
    return torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)


def apply_rotary(x, emb_sin, emb_cos):
    return x * emb_cos + rotate_half(x) * emb_sin


class PatchEmbed(nn.Module):
    """(B, C, H, W) -> (B, L, D): a stride-p conv, computed as patch extract
    + one matmul in the compute dtype (the JAX package's form)."""

    def __init__(self, patch_size: int, in_channels: int, hidden_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.compute_dtype = dtype
        self.proj = nn.Conv2d(in_channels, hidden_size, patch_size,
                              stride=patch_size)

    def forward(self, x):
        B, C, H, W = x.shape
        p = self.patch_size
        h, w = H // p, W // p
        x = x.reshape(B, C, h, p, w, p).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(B, h * w, C * p * p)
        dt = self.compute_dtype
        weight = self.proj.weight.reshape(self.proj.out_channels, -1)
        return torch.nn.functional.linear(x.to(dt), weight.to(dt),
                                          self.proj.bias.to(dt))


class TimestepEmbedder(nn.Module):
    """Sinusoidal embedding cat([cos, sin]) -> Linear -> SiLU -> Linear."""

    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.mlp = nn.Sequential(
            Linear(frequency_embedding_size, hidden_size, dtype=dtype),
            nn.SiLU(),
            Linear(hidden_size, hidden_size, dtype=dtype))

    @staticmethod
    def timestep_embedding(t, dim: int, max_period: int = 10000):
        half = dim // 2
        freqs = torch.exp(-math.log(max_period) * torch.arange(
            half, dtype=torch.float32, device=t.device) / half)
        args = t[:, None].float() * freqs[None]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        if dim % 2:
            emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
        return emb

    def forward(self, t):
        return self.mlp(self.timestep_embedding(
            t, self.frequency_embedding_size))


class LabelEmbedder(nn.Module):
    """Class-label table with a null class at index `num_classes` (used by
    CFG) when `dropout_prob > 0`.  In training each label is replaced by the
    null class with probability `dropout_prob` (the JAX `LabelEmbedder`,
    dimsum_tpu/models/embedders.py:153-165); `force_drop_ids` (1 = drop)
    decides instead of the draw, in training or not."""

    def __init__(self, num_classes: int, hidden_size: int,
                 dropout_prob: float):
        super().__init__()
        self.num_classes = num_classes
        self.dropout_prob = dropout_prob
        self.embedding_table = nn.Embedding(
            num_classes + int(dropout_prob > 0), hidden_size)

    def forward(self, labels, train: bool = False, force_drop_ids=None,
                generator: torch.Generator | None = None):
        if force_drop_ids is not None:
            drop = force_drop_ids == 1
        elif train and self.dropout_prob > 0:
            drop = torch.rand(labels.shape, generator=generator,
                              device=labels.device) < self.dropout_prob
        else:
            drop = None
        if drop is not None:
            labels = torch.where(drop, self.num_classes, labels)
        return self.embedding_table(labels)


class FinalLayer(nn.Module):
    """adaLN-modulated LayerNorm (eps 1e-6, no affine) -> Linear; the norm
    and its modulate through the norm + modulate kernel with `fused_norm`
    (`norm_impl = "ref"`: its plain version; `norm_mxu` as `Norm`'s)."""

    def __init__(self, hidden_size: int, patch_size: int, out_channels: int,
                 dtype: torch.dtype = torch.float32, fused_norm: bool = False):
        super().__init__()
        self.fused_norm = fused_norm
        self.norm_impl: str | None = None
        self.norm_mxu = False
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), Linear(hidden_size, 2 * hidden_size, dtype=dtype))
        self.linear = Linear(hidden_size,
                             patch_size * patch_size * out_channels,
                             dtype=dtype)

    def forward(self, x, c):
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=-1)
        x, _ = norm_modulate(x, None, shift=shift, scale=scale, eps=1e-6,
                             is_rms=False, fuse=self.fused_norm,
                             impl=self.norm_impl, mxu=self.norm_mxu)
        return self.linear(x)


class AdaInPosCNN(nn.Module):
    """Conditional position encoding (the JAX `AdaInPosCNN`,
    embedders.py:190-208): a depthwise 3 x 3 conv over the token grid plus
    the tokens, then a LayerNorm (eps 1e-5, fp32 math) modulated by adaLN
    shift and scale from SiLU(c).  The conv computes in the compute dtype;
    it is a Sequential so that its weights carry the reference's name
    (`pos_cnn.proj.0`)."""

    def __init__(self, embed_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.proj = nn.Sequential(nn.Conv2d(embed_dim, embed_dim, 3,
                                            padding=1, groups=embed_dim))
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), Linear(embed_dim, 2 * embed_dim, dtype=dtype))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x, c, H: int, W: int):
        B, N, C = x.shape
        dt = self.compute_dtype
        conv = self.proj[0]
        feat = x.transpose(1, 2).reshape(B, C, H, W)
        out = nn.functional.conv2d(feat.to(dt), conv.weight.to(dt),
                                   conv.bias.to(dt), padding=1, groups=C)
        x = (out + feat).reshape(B, C, N).transpose(1, 2)
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=-1)
        return modulate(layer_norm(x, self.norm.weight, self.norm.bias,
                                   eps=1e-5), shift, scale)


def unpatchify(x, patch_size: int, out_channels: int):
    """(N, T, p*p*C) -> (N, C, H, W)."""
    N, T, _ = x.shape
    p = patch_size
    h = w = int(round(T ** 0.5))
    x = x.reshape(N, h, w, p, p, out_channels)
    x = torch.einsum("nhwpqc->nchpwq", x)
    return x.reshape(N, out_channels, h * p, w * p)
