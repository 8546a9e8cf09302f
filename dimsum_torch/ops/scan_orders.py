"""Token orders, port of `dimsum_tpu/ops/scan_orders.py`.

  * The path zoo (:27-121): `sweep_path` (raster), `zigma_path`
    (serpentine), `jpeg_zigzag` (anti-diagonal zigzag), each in 8
    directional variants (4 corners x row-major "lr" / column-major "tb"),
    as int64 numpy index arrays over an N x N grid; `reverse_permut_np`,
    the inverse permutation; `build_layer_paths`, the per-layer
    (paths, inverse paths) of a scan type "<zoo>_<num>"; and
    `apply_permutation`, the gather along L.  The index builders are numpy
    and give the JAX package's arrays bit for bit.
  * `local_scan` / `local_reverse` (:123-156): windowed (LocalMamba)
    orders, pure reshapes and transposes of (B, L, C) tokens on an H x W
    grid cut into w x w windows, window after window, row-major inside a
    window (or both column-major with `column_first`), optionally
    reversed (`flip`).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["sweep_path", "zigma_path", "jpeg_zigzag", "SCAN_ZOO",
           "reverse_permut_np", "build_layer_paths", "apply_permutation",
           "local_scan", "local_reverse"]


def _corners(N):
    return [(0, 0, 1, 1), (0, N - 1, 1, -1), (N - 1, 0, -1, 1),
            (N - 1, N - 1, -1, -1)]


def _eight_variants(N, base_vh):
    """base_vh: (v, h) index arrays of the top-left corner's path; each
    corner gives a row-major path and its transpose (v and h swapped)."""
    v, h = base_vh
    paths = []
    for sr, sc, dr, dc in _corners(N):
        for a, b in ((v, h), (h, v)):
            paths.append((sr + dr * a) * N + sc + dc * b)
    return [p.astype(np.int64) for p in paths]


def sweep_path(N):
    """Raster sweep."""
    i = np.repeat(np.arange(N), N)
    j = np.tile(np.arange(N), N)
    return _eight_variants(N, (i, j))


def zigma_path(N):
    """Serpentine (ZigMa continuity): odd rows run right to left."""
    i = np.repeat(np.arange(N), N)
    j = np.tile(np.arange(N), N)
    j = np.where(i % 2 == 0, j, N - 1 - j)
    return _eight_variants(N, (i, j))


def jpeg_zigzag(N):
    """JPEG anti-diagonal zigzag: diagonal s = v + h with v descending on
    even s (up-right) and ascending on odd s."""
    vs, hs = [], []
    for s in range(2 * N - 1):
        lo, hi = max(0, s - N + 1), min(s, N - 1)
        v = np.arange(lo, hi + 1)
        if s % 2 == 0:
            v = v[::-1]
        vs.append(v)
        hs.append(s - v)
    return _eight_variants(N, (np.concatenate(vs), np.concatenate(hs)))


SCAN_ZOO = {"sweep": sweep_path, "zigma": zigma_path, "jpeg": jpeg_zigzag}


def reverse_permut_np(permutation):
    """Inverse permutation: out[perm[i]] = i."""
    perm = np.asarray(permutation)
    reverse = np.empty_like(perm)
    reverse[perm] = np.arange(len(perm))
    return reverse


def build_layer_paths(grid_size: int, scan_type: str, depth: int):
    """Per-layer (paths, inverse paths), int32 numpy arrays of shape
    (depth * num, L) for scan_type "<zoo>_<num>": the zoo's first `num`
    variants repeated, so layer i takes row i, variant i % num (the JAX
    `build_layer_paths` and the model's `_gen_paths`)."""
    zoo_name, num = scan_type.split("_")
    paths = SCAN_ZOO[zoo_name](grid_size)[: int(num)]
    revs = [reverse_permut_np(p) for p in paths]
    rows = depth * len(paths)
    fwd = np.stack([paths[i % len(paths)] for i in range(rows)])
    bwd = np.stack([revs[i % len(revs)] for i in range(rows)])
    return fwd.astype(np.int32), bwd.astype(np.int32)


def apply_permutation(x, perm):
    """Gather tokens along L: x (B, L, D), perm (L,) -> x[:, perm, :]."""
    return x.index_select(1, torch.as_tensor(perm, device=x.device,
                                              dtype=torch.long))


def _check(H: int, W: int, w: int, L: int):
    if H % w or W % w:
        raise ValueError(f"local_scan needs H % w == 0 and W % w == 0; got "
                         f"H={H}, W={W}, w={w}")
    if H * W != L:
        raise ValueError(f"{L} tokens are not an {H} x {W} grid")


def local_scan(x, w: int = 7, H: int = 14, W: int = 14, flip: bool = False,
               column_first: bool = False):
    """x: (B, L, C) in raster order -> (B, L, C) in windowed order."""
    B, L, C = x.shape
    _check(H, W, w, L)
    xg = x.reshape(B, H // w, w, W // w, w, C)
    if column_first:
        xg = xg.permute(0, 3, 1, 4, 2, 5)  # (B, Wg, Hg, wj, wi, C)
    else:
        xg = xg.permute(0, 1, 3, 2, 4, 5)  # (B, Hg, Wg, wi, wj, C)
    out = xg.reshape(B, L, C)
    return out.flip(1) if flip else out


def local_reverse(x, w: int = 7, H: int = 14, W: int = 14,
                  flip: bool = False, column_first: bool = False):
    """Inverse of `local_scan`."""
    B, L, C = x.shape
    _check(H, W, w, L)
    if flip:
        x = x.flip(1)
    if column_first:
        xg = x.reshape(B, W // w, H // w, w, w, C)
        xg = xg.permute(0, 2, 4, 1, 3, 5)  # (B, Hg, wi, Wg, wj, C)
    else:
        xg = x.reshape(B, H // w, W // w, w, w, C)
        xg = xg.permute(0, 1, 3, 2, 4, 5)
    return xg.reshape(B, L, C)
