"""Patch, timestep and label embedders, the sin-cos position table, the final
layer and unpatchify: port of `dimsum_tpu/models/embedders.py`."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from dimsum_torch.models.linear import Linear
from dimsum_torch.ops.norms import norm_modulate


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
    CFG) when `dropout_prob > 0`.  Inference only: no label dropout."""

    def __init__(self, num_classes: int, hidden_size: int,
                 dropout_prob: float):
        super().__init__()
        self.num_classes = num_classes
        self.embedding_table = nn.Embedding(
            num_classes + int(dropout_prob > 0), hidden_size)

    def forward(self, labels):
        return self.embedding_table(labels)


class FinalLayer(nn.Module):
    """adaLN-modulated LayerNorm (eps 1e-6, no affine) -> Linear."""

    def __init__(self, hidden_size: int, patch_size: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), Linear(hidden_size, 2 * hidden_size, dtype=dtype))
        self.linear = Linear(hidden_size,
                             patch_size * patch_size * out_channels,
                             dtype=dtype)

    def forward(self, x, c):
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=-1)
        x, _ = norm_modulate(x, None, shift=shift, scale=scale, eps=1e-6,
                             is_rms=False)
        return self.linear(x)


def unpatchify(x, patch_size: int, out_channels: int):
    """(N, T, p*p*C) -> (N, C, H, W)."""
    N, T, _ = x.shape
    p = patch_size
    h = w = int(round(T ** 0.5))
    x = x.reshape(N, h, w, p, p, out_channels)
    x = torch.einsum("nhwpqc->nchpwq", x)
    return x.reshape(N, out_channels, h * p, w * p)
