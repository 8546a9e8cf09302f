"""Haar DWT/IDWT and the 2-level token packing of the frequency branch,
PyTorch port of `dimsum_tpu/ops/wavelet.py`.

Filter conventions (pywt 'haar' with the reference's filter reversal), per
non-overlapping 2x2 block [[a, b], [c, d]]:

    ll = (a+b+c+d)/2   lh = (a+b-c-d)/2   hl = (a-b+c-d)/2   hh = (a-b-c+d)/2

The 2-level pack keeps the reference's channel interleave bit for bit
(group permutation i%4*4 + i//4, then "(c p1 p2)" mixing channels and
subbands), so checkpoints carry over.  Two routes, as WaveDiMBlock takes
them by default: the one-rearrange windowed pack where the scan's windows
are the dwt blocks (side == patch**2: 256 px), and `dwt_tokens` followed by
`ops.scan_orders.local_scan` otherwise (512 px: side 32, patch 4, window 8).
The JAX package's opt-in variants (the generalised one-rearrange of
DIMSUM_WAVELET_ONE_REARRANGE, the channel-last pack of DIMSUM_DWT_CL and
the basis pack of DIMSUM_FUSED_WAVELET) are not ported.
"""

from __future__ import annotations

import torch
from einops import rearrange

__all__ = ["dwt2d", "idwt2d", "dwt_tokens", "idwt_tokens",
           "dwt_tokens_windowed", "idwt_tokens_windowed",
           "windows_are_blocks"]


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


def dwt_tokens(x, num_lv: int = 2):
    """Token-grid DWT pack (the JAX `dwt_tokens`, wavelet.py:109-117):
    (B, L, C) with L a square -> (B, L, C) packed subband tokens in
    (h p1 w p2) order."""
    patch = 2 ** num_lv
    out = _dwt_pack_subbands(x, num_lv)
    return rearrange(out, "b (c p1 p2) h w -> b (h p1 w p2) c",
                     p1=patch, p2=patch)


def idwt_tokens(x, num_lv: int = 2):
    """Inverse of `dwt_tokens` (wavelet.py:187-195)."""
    patch = 2 ** num_lv
    lowest = int(round(x.shape[1] ** 0.5)) // patch
    sub = rearrange(x * float(2 ** num_lv),
                    "b (h p1 w p2) c -> b (c p1 p2) h w",
                    p1=patch, p2=patch, h=lowest)
    return _idwt_unpack_subbands(sub, num_lv)


def windows_are_blocks(L: int, num_lv: int) -> bool:
    """Whether the local scan's windows (side // patch) are the dwt blocks
    (patch), so that the windowed pack applies: side == patch**2."""
    side = int(round(L ** 0.5))
    patch = 2 ** num_lv
    return side // patch == patch


def _windows_are_blocks(L: int, num_lv: int) -> int:
    if not windows_are_blocks(L, num_lv):
        raise NotImplementedError(
            "the windowed pack takes side == patch**2 only; other sides "
            "take dwt_tokens + local_scan")
    return 2 ** num_lv


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
