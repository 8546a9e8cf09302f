"""Haar DWT/IDWT and the 2-level token packing of the frequency branch,
PyTorch port of `dimsum_tpu/ops/wavelet.py`.

Filter conventions (pywt 'haar' with the reference's filter reversal), per
non-overlapping 2x2 block [[a, b], [c, d]]:

    ll = (a+b+c+d)/2   lh = (a+b-c-d)/2   hl = (a-b+c-d)/2   hh = (a-b-c+d)/2

The 2-level pack keeps the reference's channel interleave bit for bit
(group permutation i%4*4 + i//4, then "(c p1 p2)" mixing channels and
subbands), so checkpoints carry over.  This slice ports the windowed pack
for side == patch**2 (the 256-px route of WaveDiMBlock); the generic
`dwt_tokens` + `local_scan` route of 512 px is not ported yet.
"""

from __future__ import annotations

import torch
from einops import rearrange

__all__ = ["dwt2d", "idwt2d", "dwt_tokens_windowed", "idwt_tokens_windowed"]


def dwt2d(x):
    """x: (B, C, H, W) -> (B, 4C, H/2, W/2), subband-major [ll, lh, hl, hh]."""
    B, C, H, W = x.shape
    xb = x.reshape(B, C, H // 2, 2, W // 2, 2)
    a = xb[:, :, :, 0, :, 0]
    b = xb[:, :, :, 0, :, 1]
    c = xb[:, :, :, 1, :, 0]
    d = xb[:, :, :, 1, :, 1]
    return torch.cat([0.5 * (a + b + c + d), 0.5 * (a + b - c - d),
                      0.5 * (a - b + c - d), 0.5 * (a - b - c + d)], dim=1)


def idwt2d(x):
    """x: (B, 4C, H, W) subband-major [ll, lh, hl, hh] -> (B, C, 2H, 2W)."""
    B, C4, H, W = x.shape
    ll, lh, hl, hh = x.chunk(4, dim=1)
    a = 0.5 * (ll + lh + hl + hh)
    b = 0.5 * (ll + lh - hl - hh)
    c = 0.5 * (ll - lh + hl - hh)
    d = 0.5 * (ll - lh - hl + hh)
    out = torch.stack([torch.stack([a, b], dim=-1),
                       torch.stack([c, d], dim=-1)], dim=-2)
    return out.permute(0, 1, 2, 4, 3, 5).reshape(B, C4 // 4, 2 * H, 2 * W)


def _group_perm(patch: int):
    return [i % 4 * patch + i // 4 for i in range(patch * patch)]


def _dwt_pack_subbands(x, num_lv: int):
    """(B, L, C) tokens -> (B, (c p1 p2), h, w) group-interleaved subbands."""
    side = int(round(x.shape[1] ** 0.5))
    sub = dwt2d(rearrange(x, "b (h w) c -> b c h w", h=side))
    scale = float(2 ** num_lv)
    patch = 2 ** num_lv
    if num_lv == 1:
        return sub / scale
    groups = (dwt2d(sub) / scale).chunk(patch * patch, dim=1)
    return torch.cat([groups[i] for i in _group_perm(patch)], dim=1)


def _idwt_unpack_subbands(sub, num_lv: int):
    """Inverse of `_dwt_pack_subbands`, back to (B, L, C) tokens."""
    patch = 2 ** num_lv
    if num_lv == 1:
        out = idwt2d(sub)
    else:
        groups = sub.chunk(patch * patch, dim=1)
        sub = torch.cat([groups[i] for i in _group_perm(patch)], dim=1)
        out = idwt2d(idwt2d(sub))
    return rearrange(out, "b c h w -> b (h w) c")


def _windows_are_blocks(L: int, num_lv: int) -> int:
    side = int(round(L ** 0.5))
    patch = 2 ** num_lv
    if side // patch != patch:
        raise NotImplementedError(
            "only side == patch**2 (the 256-px route) is ported; the "
            "dwt_tokens + local_scan route waits")
    return patch


def dwt_tokens_windowed(x, num_lv: int = 2, column_first: bool = False):
    """local_scan(dwt_tokens(x)) as one rearrange, for side == patch**2,
    where the local-scan windows are exactly the dwt blocks."""
    patch = _windows_are_blocks(x.shape[1], num_lv)
    out = _dwt_pack_subbands(x, num_lv)
    pattern = ("b (c p1 p2) h w -> b (w h p2 p1) c" if column_first
               else "b (c p1 p2) h w -> b (h w p1 p2) c")
    return rearrange(out, pattern, p1=patch, p2=patch)


def idwt_tokens_windowed(x, num_lv: int = 2, column_first: bool = False):
    """Inverse of `dwt_tokens_windowed`."""
    patch = _windows_are_blocks(x.shape[1], num_lv)
    pattern = ("b (w h p2 p1) c -> b (c p1 p2) h w" if column_first
               else "b (h w p1 p2) c -> b (c p1 p2) h w")
    sub = rearrange(x * float(2 ** num_lv), pattern, p1=patch, p2=patch,
                    h=patch)
    return _idwt_unpack_subbands(sub, num_lv)
