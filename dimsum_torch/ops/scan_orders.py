"""Windowed (LocalMamba) token orders, port of `local_scan` and
`local_reverse` of `dimsum_tpu/ops/scan_orders.py` (:123-156): pure
reshapes and transposes of (B, L, C) tokens on an H x W grid cut into
w x w windows, window after window, row-major inside a window (or both
column-major with `column_first`), optionally reversed (`flip`).

The path zoo of that module (`sweep_path`, `zigma_path`, `jpeg_zigzag`,
`build_layer_paths`) is not on the port's path yet.
"""

from __future__ import annotations

__all__ = ["local_scan", "local_reverse"]


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
