"""Training-time image augmentation and the fused bias-gelu helpers, the
port of `dimsum_tpu/utils/augment.py`.

The reference's DeiT "3-Augment" (grayscale / solarize / blur, one of
three, then a brightness jitter and a horizontal flip) runs on the host in
numpy, so it is kept here as the same numpy code: for the same
`np.random.Generator` it gives the same images as the JAX package.  The
bias-gelu pair (the reference's Megatron `bias_gelu.py`) and the
block-correlated noise (the reference's `transport/blurring.py`) take
tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from dimsum_torch.utils.device import resolve_device

__all__ = ["bias_gelu", "gelu_back", "gray_scale", "solarize",
           "gaussian_blur", "three_augment", "block_noise"]


# --------------------------- fused bias-gelu --------------------------------


def bias_gelu(bias, y):
    """tanh-approximate gelu(y + bias) (the reference's bias_gelu.py)."""
    x = y + bias
    return x * 0.5 * (1.0 + torch.tanh(0.79788456 * x
                                       * (1 + 0.044715 * x * x)))


def gelu_back(g, bias, y):
    """The hand-derived gradient of `bias_gelu` in y, times g (the
    reference's autograd Function)."""
    x = y + bias
    t = torch.tanh(0.79788456 * x * (1 + 0.044715 * x * x))
    ff = 0.5 * x * ((1 - t * t) * (0.79788456 + 0.1070322243 * x * x)) \
        + 0.5 * (1 + t)
    return ff * g


# ------------------------------ 3-Augment ----------------------------------


def _to_float(img):
    return img.astype(np.float32)


def gray_scale(img: np.ndarray) -> np.ndarray:
    """img: (H, W, 3) uint8."""
    g = (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])
    return np.repeat(g[..., None], 3, axis=-1).astype(img.dtype)


def solarize(img: np.ndarray, threshold: int = 128) -> np.ndarray:
    return np.where(img >= threshold, 255 - img, img).astype(img.dtype)


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    radius = max(int(3 * sigma), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    k /= k.sum()
    out = _to_float(img)
    for axis in (0, 1):
        out = np.apply_along_axis(
            lambda v: np.convolve(v, k, mode="same"), axis, out)
    return np.clip(out, 0, 255).astype(img.dtype)


def three_augment(img: np.ndarray, rng: np.random.Generator,
                  blur_sigma=(0.1, 2.0), jitter: float = 0.3,
                  hflip_p: float = 0.5) -> np.ndarray:
    """One of {grayscale, solarize, blur}, a brightness jitter and a
    horizontal flip (the reference's augment.py).  img: (H, W, 3) uint8 ->
    uint8, drawing from `rng` in the JAX package's order."""
    choice = rng.integers(0, 3)
    if choice == 0:
        img = gray_scale(img)
    elif choice == 1:
        img = solarize(img)
    else:
        img = gaussian_blur(img, rng.uniform(*blur_sigma))
    if jitter > 0:
        factor = 1.0 + rng.uniform(-jitter, jitter)
        img = np.clip(_to_float(img) * factor, 0, 255).astype(np.uint8)
    if rng.random() < hflip_p:
        img = img[:, ::-1]
    return np.ascontiguousarray(img)


def block_noise(shape, block_size: int = 1,
                generator: torch.Generator | None = None,
                device: str | torch.device = "cuda"):
    """Block-correlated Gaussian noise (the reference's
    transport/blurring.py block_noise :152-167): the sum of the
    block_size^2 copies of a standard normal draw rolled by (px, py) over
    the last two axes, divided by block_size, so each value keeps unit
    variance.  Drawn from `generator` (its device must be `device`'s) on
    `device`, the card unless the caller asks for the CPU."""
    dev = resolve_device(device)
    g = torch.randn(tuple(shape), generator=generator, device=dev)
    if block_size == 1:
        return g
    out = torch.zeros_like(g)
    for px in range(block_size):
        for py in range(block_size):
            out = out + torch.roll(g, shifts=(px, py), dims=(-2, -1))
    return out / block_size
