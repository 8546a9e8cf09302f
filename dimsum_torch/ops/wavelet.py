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

The JAX package's opt-in variants, which WaveDiMBlock takes by its
switches as the JAX block does (blocks.py:385-416):

  * `dwt_tokens_windowed` with window > patch (DIMSUM_WAVELET_ONE_REARRANGE:
    the one-rearrange pack at 512 px), bit for bit the two-step route;
  * `dwt_tokens_cl` / `idwt_tokens_cl` (DIMSUM_DWT_CL): the butterflies
    channel-last, then one transpose (wavelet.py:196-376), bit for bit the
    channel-major routes (the same sums, power-of-two scales);
  * `wavelet_pack_windowed` / `wavelet_unpack_windowed`
    (DIMSUM_FUSED_WAVELET): the pack as one product with the constant
    packet basis (wavelet.py:379-552), equal up to the order of the sums.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from einops import rearrange

__all__ = ["dwt2d", "idwt2d", "dwt_tokens", "idwt_tokens",
           "dwt_tokens_windowed", "idwt_tokens_windowed",
           "windows_are_blocks", "dwt_tokens_cl", "idwt_tokens_cl",
           "wavelet_pack_windowed", "wavelet_unpack_windowed"]


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


def windows_compose(L: int, num_lv: int) -> bool:
    """Whether local_scan(dwt_tokens) composes into one rearrange: the
    window (side // patch) is the dwt block, or a multiple of it (the JAX
    assertion, wavelet.py:133-134)."""
    side = int(round(L ** 0.5))
    patch = 2 ** num_lv
    win = side // patch
    return win == patch or (win > patch and win % patch == 0)


def _window_factor(L: int, num_lv: int):
    if not windows_compose(L, num_lv):
        raise NotImplementedError(
            "the windowed pack takes a window of the dwt block or a "
            "multiple of it; other sides take dwt_tokens + local_scan")
    patch = 2 ** num_lv
    return patch, (int(round(L ** 0.5)) // patch) // patch


def dwt_tokens_windowed(x, num_lv: int = 2, column_first: bool = False):
    """local_scan(dwt_tokens(x), w=side // patch) as one rearrange (the JAX
    `dwt_tokens_windowed`, wavelet.py:120-152): where the windows are the
    dwt blocks (side == patch**2), or, window > patch (512 px: side 32,
    window 8), with each window row split as (h2, h1)."""
    patch, f = _window_factor(x.shape[1], num_lv)
    out = _dwt_pack_subbands(x, num_lv)
    if f == 1:
        pattern = ("b (c p1 p2) h w -> b (w h p2 p1) c" if column_first
                   else "b (c p1 p2) h w -> b (h w p1 p2) c")
        return rearrange(out, pattern, p1=patch, p2=patch)
    pattern = ("b (c p1 p2) (h2 h1) (w2 w1) -> b (w2 h2 w1 p2 h1 p1) c"
               if column_first else
               "b (c p1 p2) (h2 h1) (w2 w1) -> b (h2 w2 h1 p1 w1 p2) c")
    return rearrange(out, pattern, p1=patch, p2=patch, h1=f, w1=f)


def idwt_tokens_windowed(x, num_lv: int = 2, column_first: bool = False):
    """Inverse of `dwt_tokens_windowed`."""
    patch, f = _window_factor(x.shape[1], num_lv)
    if f == 1:
        pattern = ("b (w h p2 p1) c -> b (c p1 p2) h w" if column_first
                   else "b (h w p1 p2) c -> b (c p1 p2) h w")
        sub = rearrange(x * float(2 ** num_lv), pattern, p1=patch, p2=patch,
                        h=patch)
    else:
        pattern = ("b (w2 h2 w1 p2 h1 p1) c -> b (c p1 p2) (h2 h1) (w2 w1)"
                   if column_first else
                   "b (h2 w2 h1 p1 w1 p2) c -> b (c p1 p2) (h2 h1) (w2 w1)")
        sub = rearrange(x * float(2 ** num_lv), pattern, p1=patch, p2=patch,
                        h1=f, w1=f, h2=patch, w2=patch)
    return _idwt_unpack_subbands(sub, num_lv)


# ---------------------------------------------------------------------------
# The channel-last pack (DIMSUM_DWT_CL): butterflies over (B, H, W, C), the
# subbands becoming the high output-channel bits, then one transpose.
# ---------------------------------------------------------------------------

def _quads_cl(x):
    """x: (B, H, W, C) -> the four 2x2-block corners, (B, H/2, W/2, C)."""
    B, H, W, C = x.shape
    xb = x.reshape(B, H // 2, 2, W // 2, 2, C)
    return (xb[:, :, 0, :, 0], xb[:, :, 0, :, 1],
            xb[:, :, 1, :, 0], xb[:, :, 1, :, 1])


def _butterfly_cl(x, scale: float):
    a, b, c, d = _quads_cl(x)
    return [scale * (a + b + c + d), scale * (a + b - c - d),
            scale * (a - b + c - d), scale * (a - b - c + d)]


def _ibutterfly_cl(ll, lh, hl, hh, scale: float):
    a = scale * (ll + lh + hl + hh)
    b = scale * (ll + lh - hl - hh)
    c = scale * (ll - lh + hl - hh)
    d = scale * (ll - lh - hl + hh)
    B, H, W, C = a.shape
    y = torch.stack([a, b, c, d], dim=3).reshape(B, H, W, 2, 2, C)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(B, 2 * H, 2 * W, C)


def _cl_axis_order(mode, column_first: bool, two_level_grid: bool):
    """The final transpose's axis order (the JAX `_cl_axis_order`)."""
    if two_level_grid:
        if column_first:
            return (0, 3, 1, 4, 8, 2, 7, 5, 6)  # b (w2 h2 w1 p2 h1 p1) c
        return (0, 1, 3, 2, 7, 4, 8, 5, 6)      # b (h2 w2 h1 p1 w1 p2) c
    return {"plain": (0, 1, 5, 2, 6, 3, 4),     # b (h p1 w p2) c
            "grid_t": (0, 2, 6, 1, 5, 3, 4),    # b (w p2 h p1) c
            "win_row": (0, 1, 2, 5, 6, 3, 4),   # b (h w p1 p2) c
            "win_col": (0, 2, 1, 6, 5, 3, 4)}[mode]  # b (w h p2 p1) c


def _cl_mode(window_scan, grid_transpose, column_first, win, patch):
    if window_scan:
        if win == patch:
            return ("win_col" if column_first else "win_row"), False
        if win % patch:
            raise ValueError("channel-last pack needs window % patch == 0")
        return None, True
    return ("grid_t" if grid_transpose else "plain"), False


def _cl_check(C, side, num_lv):
    patch = 2 ** num_lv
    n = patch * patch
    if C % n or side % patch:
        raise ValueError(
            f"channel-last pack needs C % {n} == 0 and side % {patch} == 0 "
            f"(got C={C}, side={side})")
    if num_lv not in (1, 2):
        raise ValueError("the channel-last pack takes num_lv 1 or 2")
    return patch, n


def dwt_tokens_cl(x, num_lv: int = 2, *, window_scan: bool = False,
                  grid_transpose: bool = False, column_first: bool = False):
    """The channel-last twin of dwt_tokens [+ local_scan | + the token
    transpose] (the JAX `dwt_tokens_cl`, wavelet.py:281-319):
    `window_scan` gives local_scan(dwt_tokens(x), w=side // patch),
    `grid_transpose` the transposed packed grid, neither dwt_tokens(x)."""
    B, L, C = x.shape
    side = int(round(L ** 0.5))
    patch, n = _cl_check(C, side, num_lv)
    hi, Hb = C // n, side // patch
    xg = x.reshape(B, side, side, C)
    if num_lv == 1:
        subs = _butterfly_cl(xg, 0.25)
    else:
        subs = []
        for t in _butterfly_cl(xg, 0.5):
            subs.extend(_butterfly_cl(t, 0.125))
    S = torch.stack(subs, dim=3).reshape(B, Hb, Hb, n, hi, patch, patch)
    win = side // patch
    mode, two_level = _cl_mode(window_scan, grid_transpose, column_first,
                               win, patch)
    if two_level:
        f = win // patch
        S = S.reshape(B, patch, f, patch, f, n, hi, patch, patch)
    return S.permute(*_cl_axis_order(mode, column_first,
                                     two_level)).reshape(B, L, C)


def idwt_tokens_cl(y, num_lv: int = 2, *, window_scan: bool = False,
                   grid_transpose: bool = False, column_first: bool = False):
    """Inverse of `dwt_tokens_cl` (the same mode flags)."""
    B, L, C = y.shape
    side = int(round(L ** 0.5))
    patch, n = _cl_check(C, side, num_lv)
    hi, Hb = C // n, side // patch
    win = side // patch
    mode, two_level = _cl_mode(window_scan, grid_transpose, column_first,
                               win, patch)
    order = _cl_axis_order(mode, column_first, two_level)
    if two_level:
        f = win // patch
        shp = [B, patch, f, patch, f, n, hi, patch, patch]
    else:
        shp = [B, Hb, Hb, n, hi, patch, patch]
    inv = np.argsort(order).tolist()
    yb = y.reshape([shp[ax] for ax in order]).permute(*inv)
    S = yb.reshape(B, Hb, Hb, n, C) * float(2 ** num_lv)
    subs = [S[:, :, :, i] for i in range(n)]
    if num_lv == 1:
        return _ibutterfly_cl(*subs, 0.5).reshape(B, L, C)
    lvl1 = [_ibutterfly_cl(*subs[4 * s1:4 * s1 + 4], 0.5) for s1 in range(4)]
    return _ibutterfly_cl(*lvl1, 0.5).reshape(B, L, C)


# ---------------------------------------------------------------------------
# The basis pack (DIMSUM_FUSED_WAVELET): local_scan(dwt_tokens(x)) as one
# product with the constant 16 x 16 packet basis, then one permutation.
# ---------------------------------------------------------------------------

def _np_dwt_tokens(x, num_lv: int):
    """numpy `dwt_tokens` on float64, to probe the packet basis."""
    return dwt_tokens(torch.from_numpy(x), num_lv).numpy()


def _np_idwt_tokens(x, num_lv: int):
    return idwt_tokens(torch.from_numpy(x), num_lv).numpy()


@functools.lru_cache(maxsize=None)
def _packet_basis(num_lv: int):
    """(M0, M0inv): M0[q, k] takes the block's row-major token k to packet
    coefficient q, probed through `dwt_tokens` on one channel (the JAX
    `_packet_basis`, wavelet.py:439-461); M0inv its inverse."""
    n = (2 ** num_lv) ** 2
    eye = np.eye(n)[:, :, None]  # n one-hot single-channel inputs
    M0 = np.stack([_np_dwt_tokens(eye[k:k + 1], num_lv)[0][:, 0]
                   for k in range(n)], axis=1)
    M0inv = np.stack([_np_idwt_tokens(eye[q:q + 1], num_lv)[0][:, 0]
                      for q in range(n)], axis=1)
    assert np.allclose(M0 @ M0inv, np.eye(n)), "packet basis not inverse"
    return np.asarray(M0, np.float32), np.asarray(M0inv, np.float32)


@functools.lru_cache(maxsize=None)
def _pack_perm(side: int, num_lv: int, window: int, column_first: bool):
    """The permutation from the block-major product layout (h, w, p1, p2)
    to local_scan order over the packed grid (the JAX `_pack_perm`)."""
    p = 2 ** num_lv
    Hb = side // p
    f = np.arange(side * side).reshape(Hb, Hb, p, p)
    F = f.transpose(0, 2, 1, 3).reshape(side, side)
    Hg, wz = side // window, window
    G = F.reshape(Hg, wz, Hg, wz)
    order = (G.transpose(2, 0, 3, 1) if column_first
             else G.transpose(0, 2, 1, 3))
    return np.asarray(order.reshape(-1), np.int64)


def _basis_check(C, side, num_lv):
    p = 2 ** num_lv
    n = p * p
    if C % n or side % p:
        raise ValueError(
            f"fused wavelet pack needs C % {n} == 0 and side % {p} == 0 "
            f"(got C={C}, side={side}); use local_scan(dwt_tokens(x))")
    return p, n


def wavelet_pack_windowed(x, num_lv: int = 2, window: int | None = None,
                          column_first: bool = False):
    """local_scan(dwt_tokens(x, num_lv), w=window) (window: side // patch
    by default) through the packet basis (the JAX `wavelet_pack_windowed`,
    wavelet.py:481-517): channels split as (g, r), the block's 16 tokens
    contracted with M0 in x's dtype (its entries are signed powers of
    two)."""
    B, L, C = x.shape
    side = int(round(L ** 0.5))
    p, n = _basis_check(C, side, num_lv)
    window = side // p if window is None else window
    Hb, G = side // p, C // n
    M0, _ = _packet_basis(num_lv)
    xb = x.reshape(B, Hb, p, Hb, p, G, n).permute(0, 1, 3, 2, 4, 5, 6)
    xb = xb.reshape(B, Hb * Hb, n, G, n)
    y = torch.einsum("bnkgr,qk->bnrqg", xb,
                     torch.as_tensor(M0, dtype=x.dtype, device=x.device))
    y = y.reshape(B, L, C)
    if window == p and not column_first:
        return y
    if window == p:
        y = y.reshape(B, Hb, Hb, p, p, C).permute(0, 2, 1, 4, 3, 5)
        return y.reshape(B, L, C)
    perm = torch.as_tensor(_pack_perm(side, num_lv, window, column_first),
                           device=x.device)
    return y.index_select(1, perm)


def wavelet_unpack_windowed(x, num_lv: int = 2, window: int | None = None,
                            column_first: bool = False):
    """Inverse of `wavelet_pack_windowed`: idwt_tokens(local_reverse(x))."""
    B, L, C = x.shape
    side = int(round(L ** 0.5))
    p, n = _basis_check(C, side, num_lv)
    window = side // p if window is None else window
    Hb, G = side // p, C // n
    _, M0inv = _packet_basis(num_lv)
    if window == p and column_first:
        y = x.reshape(B, Hb, Hb, p, p, C).permute(0, 2, 1, 4, 3, 5)
        y = y.reshape(B, L, C)
    elif window != p:
        perm = _pack_perm(side, num_lv, window, column_first)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(L)
        y = x.index_select(1, torch.as_tensor(inv, device=x.device))
    else:
        y = x
    yb = y.reshape(B, Hb * Hb, n, n, G)
    out = torch.einsum("bnrqg,kq->bnkgr", yb,
                       torch.as_tensor(M0inv, dtype=x.dtype,
                                       device=x.device))
    out = out.reshape(B, Hb, Hb, p, p, G, n).permute(0, 1, 3, 2, 4, 5, 6)
    return out.reshape(B, L, C)
