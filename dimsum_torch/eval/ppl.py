"""Perceptual Path Length over the diffusion sampler, port of
`dimsum_tpu/eval/ppl.py` (the reference's perceptual_path_length.py:
slerp :26-36, the sampler :41-103, the 1-99 percentile-filtered mean
:139-143).

The metric's math is the reference's (z-space slerp endpoints, epsilon
1e-4, center crop, downsampling to 256, the [0, 255] range, the LPIPS
distance / eps^2, the filtered mean), with the diffusion model's noise
space in place of StyleGAN's w-space: the "generator" is the deterministic
ODE sampler (noise z -> image).  The draws come from a numpy RNG, so the
port and the JAX package draw the same z, t and labels.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def slerp(a: np.ndarray, b: np.ndarray, t) -> np.ndarray:
    """Spherical interpolation over the last axis (reference :26-36)."""
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    d = np.sum(a * b, axis=-1, keepdims=True)
    p = t * np.arccos(np.clip(d, -1.0, 1.0))
    c = b - d * a
    c = c / np.linalg.norm(c, axis=-1, keepdims=True)
    out = a * np.cos(p) + c * np.sin(p)
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


def _prep_images(img: np.ndarray, crop: bool) -> np.ndarray:
    """Center crop + downsample-to-256 + [0,255] range (reference :79-96).
    img: (N, C, H, W) float in [-1, 1]."""
    if crop:
        assert img.shape[2] == img.shape[3]
        c = img.shape[2] // 8
        img = img[:, :, c * 3:c * 7, c * 2:c * 6]
    factor = img.shape[2] // 256
    if factor > 1:
        n, ch, h, w = img.shape
        img = img.reshape(n, ch, h // factor, factor,
                          w // factor, factor).mean(axis=(3, 5))
    img = (img + 1) * (255 / 2)
    if img.shape[1] == 1:
        img = np.repeat(img, 3, axis=1)
    return img


def compute_ppl(
    sampler_fn: Callable[[np.ndarray, Optional[np.ndarray]], np.ndarray],
    lpips_fn: Callable[[np.ndarray], np.ndarray],
    z_shape,
    num_samples: int = 50_000,
    epsilon: float = 1e-4,
    sampling: str = "end",
    crop: bool = True,
    batch_size: int = 2,
    num_classes: int = 0,
    seed: int = 0,
) -> float:
    """sampler_fn(z, y) -> images (N, C, H, W) in [-1, 1], DETERMINISTIC in
    z (an ODE sample path); lpips_fn(img_0_255 float NCHW) -> (N, F) LPIPS
    embeddings (squared-difference sum == perceptual distance, the
    vgg16.pt `return_lpips=True` contract)."""
    assert sampling in ("full", "end")
    rng = np.random.default_rng(seed)
    dists = []
    done = 0
    zdim = int(np.prod(z_shape))
    while done < num_samples:
        bs = min(batch_size, num_samples - done)
        t = rng.uniform(size=(bs, 1)) * (1.0 if sampling == "full" else 0.0)
        z0 = rng.standard_normal((bs, zdim))
        z1 = rng.standard_normal((bs, zdim))
        zt0 = slerp(z0, z1, t)
        zt1 = slerp(z0, z1, t + epsilon)
        y = (rng.integers(0, num_classes, size=2 * bs)
             if num_classes > 0 else None)
        z = np.concatenate([zt0, zt1]).reshape(2 * bs, *z_shape)
        # scale back to an N(0, I)-radius sphere: slerp returns unit vectors
        z = z * np.sqrt(zdim)
        img = np.asarray(sampler_fn(z.astype(np.float32), y))
        img = _prep_images(img, crop)
        feats = np.asarray(lpips_fn(img.astype(np.float32)))
        f0, f1 = feats[:bs], feats[bs:]
        dists.append(((f0 - f1) ** 2).sum(axis=1) / epsilon ** 2)
        done += bs
    dist = np.concatenate(dists)[:num_samples]
    lo = np.percentile(dist, 1, method="lower")
    hi = np.percentile(dist, 99, method="higher")
    return float(np.extract((dist >= lo) & (dist <= hi), dist).mean())
