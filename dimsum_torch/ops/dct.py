"""DCT-II and its inverse as products with a frozen fp32 basis, port of
`dimsum_tpu/ops/dct.py` (:36-137).  Two consumers:

  * the DCTBlock frequency branch: `dct_patch` is the reference's strided
    grouped conv with a frozen DCT basis over non-overlapping k x k
    patches, keeping the r x r low-frequency corner, and `idct_patch` its
    1x1 conv + PixelShuffle inverse, each as a block reshape and two small
    products;
  * the blurring interpolant (`transport/path.py::dct_blur`): the
    patchwise orthonormal 2-D DCT `dct_2d` and its inverse `idct_2d`.

Basis: M[k, n] = sqrt(2/N) c_k cos((2n+1) k pi / (2N)), c_0 = 1/sqrt(2),
so dct_1d(x) = M x and idct_1d(X) = M^T X (orthonormal).  The basis is
built in float64 with numpy and rounded to fp32 once, as the JAX package
builds it, and copied to each device once (a frozen constant: no host
copy, and so no stream synchronisation, a call); the products run in
fp32 (the JAX "highest" precision) and return fp32 whatever the input's
type, as JAX promotes a bf16 input against the fp32 basis.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["dct_basis", "dct_1d", "idct_1d", "dct_patch", "idct_patch",
           "dct_2d", "idct_2d"]


@functools.lru_cache(maxsize=None)
def _basis_np(n: int) -> np.ndarray:
    k = np.arange(n)[:, None].astype(np.float64)
    x = np.arange(n)[None, :].astype(np.float64)
    m = np.sqrt(2.0 / n) * np.cos((2 * x + 1) * k * np.pi / (2 * n))
    m[0] /= np.sqrt(2.0)
    return m.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _on_device(name: str, n: int, device: torch.device) -> torch.Tensor:
    """The constant `name` of size n, copied to `device` once.  Made
    outside inference mode, so that a basis first made while sampling
    can be saved for a backward later."""
    if name == "basis":
        value = _basis_np(n)
    else:  # torch-dct's scale of the unnormalized DCT against the ortho one
        value = np.full((n,), np.sqrt(2.0 * n), np.float32)
        value[0] = np.sqrt(4.0 * n) / np.sqrt(2.0)
    with torch.inference_mode(False):
        return torch.tensor(value, device=device)


def dct_basis(n: int, device=None) -> torch.Tensor:
    """The orthonormal DCT-II basis (n, n), fp32, made once a device."""
    return _on_device("basis", n, torch.device(device or "cpu"))


def _unnormalized_scale(n: int, device) -> torch.Tensor:
    return _on_device("scale", n, torch.device(device))


def dct_1d(x, norm: str = "ortho"):
    """DCT-II over the last axis."""
    n = x.shape[-1]
    y = torch.einsum("...n,kn->...k", x.float(), dct_basis(n, x.device))
    if norm != "ortho":
        y = y * _unnormalized_scale(n, x.device)
    return y


def idct_1d(x, norm: str = "ortho"):
    """Inverse of `dct_1d` over the last axis."""
    n = x.shape[-1]
    if norm != "ortho":
        x = x / _unnormalized_scale(n, x.device)
    return torch.einsum("...k,kn->...n", x.float(), dct_basis(n, x.device))


def dct_patch(x, ksize: int, rsize: int | None = None):
    """Patchwise 2-D DCT: x (B, C, H, W) -> (B, C * rsize^2, H/k, W/k),
    channels in (c, v, u) order with c slowest (the grouped conv's output
    layout); the k x k basis cut to its first rsize frequencies."""
    rsize = ksize if rsize is None else rsize
    B, C, H, W = x.shape
    k = ksize
    m = dct_basis(k, x.device)[:rsize]
    blk = x.float().reshape(B, C, H // k, k, W // k, k)
    out = torch.einsum("bchywx,vy,ux->bcvuhw", blk, m, m)
    return out.reshape(B, C * rsize * rsize, H // k, W // k)


def idct_patch(x, ksize: int, rsize: int | None = None):
    """Inverse of `dct_patch`: (B, C * rsize^2, h, w) -> (B, C, h k, w k)."""
    rsize = ksize if rsize is None else rsize
    B, CR, H, W = x.shape
    C = CR // (rsize * rsize)
    k = ksize
    m = dct_basis(k, x.device)[:rsize]
    coef = x.float().reshape(B, C, rsize, rsize, H, W)
    blk = torch.einsum("bcvuhw,vy,ux->bchywx", coef, m, m)
    return blk.reshape(B, C, H * k, W * k)


def _to_patches(x, size: int):
    B, C, H, W = x.shape
    return (x.reshape(B, C, H // size, size, W // size, size)
            .permute(0, 2, 4, 1, 3, 5).reshape(-1, C, size, size))


def _from_patches(x, image_size: int):
    _, C, _, size = x.shape
    g = image_size // size
    return (x.reshape(-1, g, g, C, size, size).permute(0, 3, 1, 4, 2, 5)
            .reshape(-1, C, image_size, image_size))


def dct_2d(x, size: int, norm: str = "ortho", keeps_size: bool = True):
    """Patchwise 2-D DCT over the last two axes of (B, C, H, W), in
    size x size patches (the reference's blurring.dct_2d)."""
    origin = x.shape[-1]
    xp = _to_patches(x, size) if origin > size else x
    y = dct_1d(xp, norm)
    y = dct_1d(y.transpose(-1, -2), norm).transpose(-1, -2)
    if keeps_size and origin > size:
        y = _from_patches(y, origin)
    return y


def idct_2d(x, size: int, norm: str = "ortho"):
    """Inverse of `dct_2d`."""
    origin = x.shape[-1]
    xp = _to_patches(x, size) if origin > size else x
    y = idct_1d(xp, norm)
    y = idct_1d(y.transpose(-1, -2), norm).transpose(-1, -2)
    if origin > size:
        y = _from_patches(y, origin)
    return y
