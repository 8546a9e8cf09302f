"""DiM blocks on the main path: port of `dimsum_tpu/models/blocks.py`
(Norm, AdaLN, MixerBlockCore, WaveDiMBlock, DiTBlock, DiMBlockCombined).

Every block follows the reference's prenorm structure: the residual add
comes first (fused add + norm), the summed residual is threaded beside the
hidden states, and the condition enters through adaLN shift/scale/gate.
Token reorderings (transpose, reverse) are explicit rearranges and flips.
MixerBlockCore and WaveDiMBlock are ported as the combined block uses
them: no FFN, and their identity "norm" (`_add_identity_norm`) is left out:
no residual enters them there and the one it would return is discarded.
"""

from __future__ import annotations

import torch
import torch.nn as nn
from einops import rearrange

from dimsum_torch.models.attention import Attention, CrossAttentionFusion
from dimsum_torch.models.linear import Linear
from dimsum_torch.models.mamba import Mamba
from dimsum_torch.models.mlp import GatedMLP
from dimsum_torch.ops.norms import fused_add_norm, modulate, norm_modulate
from dimsum_torch.ops.scan_orders import local_reverse, local_scan
from dimsum_torch.ops.wavelet import (dwt_tokens, dwt_tokens_windowed,
                                      idwt_tokens, idwt_tokens_windowed,
                                      windows_are_blocks)


def drop_path_fn(x, rate: float, generator: torch.Generator | None = None):
    """Per-sample stochastic depth (timm semantics, the JAX `drop_path_fn`,
    blocks.py:77-85): keep each sample with probability 1 - rate and scale
    the kept ones by 1 / (1 - rate).  Callers apply it only in training."""
    keep = 1.0 - rate
    mask = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1),
                      generator=generator, device=x.device) < keep
    return x * (mask.to(x.dtype) / keep)


class Norm(nn.Module):
    """RMSNorm (weight only) with fp32 math.  With `branch` or `shift` it
    is the fused (gate-add +) add + norm + modulate and returns
    (modulated, total); otherwise fused add + norm."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x, residual=None, prenorm=True, branch=None, gate=None,
                shift=None, scale=None):
        if branch is not None or shift is not None:
            total_dtype = torch.float32 if residual is not None else x.dtype
            return norm_modulate(
                x, self.weight, branch=branch, gate=gate, residual=residual,
                shift=shift, scale=scale, eps=self.eps,
                total_dtype=total_dtype)
        return fused_add_norm(x, self.weight, residual=residual, eps=self.eps,
                              prenorm=prenorm)


def AdaLN(c_dim: int, dim: int, n_chunks: int,
          dtype: torch.dtype = torch.float32) -> nn.Sequential:
    """SiLU -> Linear(n_chunks * dim); the JAX package zero-initializes the
    Linear (adaLN-Zero).  Split the output with `.chunk(n_chunks, -1)`."""
    fc = Linear(c_dim, n_chunks * dim, dtype=dtype)
    nn.init.zeros_(fc.weight)
    nn.init.zeros_(fc.bias)
    return nn.Sequential(nn.SiLU(), fc)


def _transpose_tokens(x, h: int, w: int):
    return rearrange(x, "n (h w) c -> n (w h) c", h=h, w=w)


class _InnerMixerBlock(nn.Module):
    """Token reordering, then the mixer under a 3-way adaLN (shift, scale,
    gate) -- the shared body of the combined block's two halves; subclasses
    give the token order."""

    def __init__(self, dim: int, c_dim: int, reverse: bool, d_cond: int | None,
                 dtype: torch.dtype):
        super().__init__()
        self.reverse = reverse
        self.mixer = Mamba(dim, d_cond=d_cond, dtype=dtype)
        self.adaLN_modulation = AdaLN(c_dim, dim, 3, dtype)

    def forward(self, hidden_states, c):
        side = int(round(hidden_states.shape[1] ** 0.5))
        hidden_states = self._order(hidden_states, side)
        if self.reverse:
            hidden_states = hidden_states.flip(1)
        shift, scale, gate = self.adaLN_modulation(c).chunk(3, -1)
        mixer_out = self.mixer(modulate(hidden_states, shift, scale), c)
        hidden_states = hidden_states + gate[:, None, :] * mixer_out
        if self.reverse:
            hidden_states = hidden_states.flip(1)
        return self._unorder(hidden_states, side)


class MixerBlockCore(_InnerMixerBlock):
    """The spatial half (DiMBlockRaw): tokens in raster order, transposed
    to column order when `transpose`, reversed when `reverse`."""

    def __init__(self, dim: int, c_dim: int, reverse: bool = False,
                 transpose: bool = False, d_cond: int | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dim, c_dim, reverse, d_cond, dtype)
        self.transpose = transpose

    def _order(self, x, side):
        return _transpose_tokens(x, side, side) if self.transpose else x

    _unorder = _order


class WaveDiMBlock(_InnerMixerBlock):
    """The frequency half: 2-level Haar pack in windowed scan order (column
    first when `transpose`), the JAX default routing (blocks.py:398-436,
    :481-492): where the windows are the dwt blocks (side == patch**2, 256
    px) one rearrange does both; otherwise (512 px: side 32, window 8)
    `dwt_tokens`, then `local_scan` over side // patch windows."""

    num_lv = 2

    def __init__(self, dim: int, c_dim: int, reverse: bool = False,
                 transpose: bool = False, d_cond: int | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dim, c_dim, reverse, d_cond, dtype)
        self.column_first = bool(transpose)

    def _window(self, side):
        return dict(w=side // 2 ** self.num_lv, H=side, W=side,
                    column_first=self.column_first)

    def _order(self, x, side):
        if windows_are_blocks(x.shape[1], self.num_lv):
            return dwt_tokens_windowed(x, self.num_lv,
                                       column_first=self.column_first)
        return local_scan(dwt_tokens(x, self.num_lv), **self._window(side))

    def _unorder(self, x, side):
        if windows_are_blocks(x.shape[1], self.num_lv):
            return idwt_tokens_windowed(x, self.num_lv,
                                        column_first=self.column_first)
        return idwt_tokens(local_reverse(x, **self._window(side)),
                           self.num_lv)


class DiTBlock(nn.Module):
    """adaLN-Zero attention block; its LayerNorms use eps 1e-6, no affine."""

    def __init__(self, hidden_size: int, num_heads: int,
                 mlp_ratio: float = 4.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attn = Attention(hidden_size, num_heads, qkv_bias=True,
                              dtype=dtype)
        self.mlp = GatedMLP(hidden_size, int(hidden_size * mlp_ratio),
                            dtype=dtype)
        self.adaLN_modulation = AdaLN(hidden_size, hidden_size, 6, dtype)

    def forward(self, x, c):
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
         gate_mlp) = self.adaLN_modulation(c).chunk(6, -1)
        h1, _ = norm_modulate(x, None, shift=shift_msa, scale=scale_msa,
                              eps=1e-6, is_rms=False)
        h2, x = norm_modulate(x, None, branch=self.attn(h1), gate=gate_msa,
                              shift=shift_mlp, scale=scale_mlp, eps=1e-6,
                              is_rms=False)
        return x + gate_mlp[:, None, :] * self.mlp(h2)


class DiMBlockCombined(nn.Module):
    """The published DiMSUM block: add + RMSNorm -> split channels ->
    spatial half through a mixer block and frequency half through a wavelet
    block -> CrossAttentionFusion -> residual -> adaLN-gated GatedMLP.  The
    frequency half scans column first in the reversed blocks.

    In training, stochastic depth at `drop_path_rate` drops the incoming
    hidden states per sample where they merge into the residual, and only
    when a residual exists (blocks.py:94-98, :784-793)."""

    def __init__(self, dim: int, reverse: bool = False,
                 transpose: bool = False, d_cond: int | None = None,
                 drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        half = dim // 2
        self.norm = Norm(dim)
        self.spatial_mamba = MixerBlockCore(
            half, dim, reverse=reverse, transpose=transpose, d_cond=d_cond,
            dtype=dtype)
        self.freq_mamba = WaveDiMBlock(
            half, dim, reverse=False, transpose=reverse, d_cond=d_cond,
            dtype=dtype)
        self.proj = CrossAttentionFusion(dim, num_heads=8, qkv_bias=True,
                                         dtype=dtype)
        self.adaLN_modulation = AdaLN(dim, dim, 3, dtype)
        self.norm_2 = Norm(dim)
        self.mlp = GatedMLP(dim, 4 * dim, dtype=dtype)

    def forward(self, hidden_states, residual=None, c=None,
                train: bool = False,
                generator: torch.Generator | None = None):
        if train and self.drop_path_rate > 0.0 and residual is not None:
            hidden_states = drop_path_fn(hidden_states, self.drop_path_rate,
                                         generator)
        hidden_states, residual = self.norm(hidden_states, residual)
        x1, x2 = hidden_states.chunk(2, dim=2)
        x1 = self.spatial_mamba(x1, c)
        x2 = self.freq_mamba(x2, c)
        fused = self.proj(x1, x2)
        shift_mlp, scale_mlp, gate_mlp = self.adaLN_modulation(c).chunk(3, -1)
        moded, hidden_states = self.norm_2(
            hidden_states, prenorm=False, branch=fused, shift=shift_mlp,
            scale=scale_mlp)
        hidden_states = hidden_states + gate_mlp[:, None, :] * self.mlp(moded)
        return hidden_states, residual
