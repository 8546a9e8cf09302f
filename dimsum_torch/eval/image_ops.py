"""StyleGAN-ADA image ops, upfirdn2d and bias_act, in plain PyTorch: the
port of `dimsum_tpu/eval/image_ops.py`.

Reference: `eval_toolbox/torch_utils/ops/upfirdn2d.{py,cu}` and
`bias_act.{py,cu}`, CUDA plugins the reference needs only to run legacy
StyleGAN pickles for the PPL metric.  The JAX package computes them in
plain XLA (a pad, a depthwise FIR convolution, a stride), not in a Pallas
kernel, and so does this module in plain PyTorch; they run on the device of
their inputs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from dimsum_torch.utils.device import resolve_device

__all__ = ["bias_act", "setup_filter", "upfirdn2d", "upsample2d",
           "downsample2d"]

_ACTS = {
    "linear": (lambda x, alpha: x, 1.0),
    "relu": (lambda x, alpha: torch.clamp_min(x, 0), math.sqrt(2.0)),
    "lrelu": (lambda x, alpha: torch.where(x >= 0, x, x * alpha),
              math.sqrt(2.0)),
    "tanh": (lambda x, alpha: torch.tanh(x), 1.0),
    "sigmoid": (lambda x, alpha: torch.sigmoid(x), 1.0),
    "elu": (lambda x, alpha: F.elu(x), 1.0),
    "selu": (lambda x, alpha: F.selu(x), 1.0),
    # log(1 + exp(x)) without overflow, jax.nn.softplus's form
    "softplus": (lambda x, alpha: x.clamp_min(0)
                 + torch.log1p(torch.exp(-x.abs())), 1.0),
    "swish": (lambda x, alpha: x * torch.sigmoid(x), math.sqrt(2.0)),
}


def bias_act(x, b=None, dim: int = 1, act: str = "linear",
             alpha: float = 0.2, gain: float | None = None,
             clamp: float | None = None):
    """Bias + activation + gain + clamp (reference bias_act.py)."""
    fn, def_gain = _ACTS[act]
    gain = def_gain if gain is None else gain
    if b is not None:
        shape = [1] * x.ndim
        shape[dim] = -1
        x = x + b.reshape(shape)
    x = fn(x, alpha)
    if gain != 1:
        x = x * gain
    if clamp is not None and clamp >= 0:
        x = x.clamp(-clamp, clamp)
    return x


def setup_filter(f, normalize: bool = True, gain: float = 1.0,
                 separable=None, device: str | torch.device = "cuda"):
    """FIR filter setup (reference upfirdn2d.setup_filter), fp32 on
    `device`, the card unless the caller asks for the CPU."""
    f = torch.as_tensor(f, dtype=torch.float32, device=resolve_device(device))
    if f.ndim == 0:
        f = f[None]
    if separable is None:
        separable = f.ndim == 1 and f.numel() >= 8
    if f.ndim == 1 and not separable:
        f = torch.outer(f, f)
    if normalize:
        f = f / f.sum()
    return f * (gain ** (f.ndim / 2))


def upfirdn2d(x, f, up: int = 1, down: int = 1, padding=0,
              gain: float = 1.0):
    """Upsample -> FIR filter -> downsample (reference upfirdn2d.py).

    x: (B, C, H, W); f: 2-D (or 1-D separable) filter."""
    B, C, H, W = x.shape
    if isinstance(padding, int):
        padx0 = padx1 = pady0 = pady1 = padding
    else:
        padx0, padx1, pady0, pady1 = padding
    f = torch.as_tensor(f, dtype=torch.float32, device=x.device)
    if f.ndim == 1:
        f = torch.outer(f, f)
    # upsample by zero insertion
    if up > 1:
        xz = x.new_zeros((B, C, H, up, W, up))
        xz[:, :, :, 0, :, 0] = x
        x = xz.reshape(B, C, H * up, W * up)
    # pad (a negative pad crops)
    x = F.pad(x, (max(padx0, 0), max(padx1, 0), max(pady0, 0),
                  max(pady1, 0)))
    x = x[:, :, max(-pady0, 0): x.shape[2] - max(-pady1, 0),
          max(-padx0, 0): x.shape[3] - max(-padx1, 0)]
    # FIR: correlate with the flipped filter, channel by channel
    kernel = torch.flip(f, (0, 1)) * (gain * (up ** 2))
    kernel = kernel[None, None].repeat(C, 1, 1, 1).to(x.dtype)
    x = F.conv2d(x, kernel, groups=C)
    if down > 1:
        x = x[:, :, ::down, ::down]
    return x


def upsample2d(x, f, up: int = 2, gain: float = 1.0):
    fh = f.shape[-1]
    p = fh - up
    return upfirdn2d(x, f, up=up,
                     padding=((p + 1) // 2 + up - 1, p // 2,
                              (p + 1) // 2 + up - 1, p // 2), gain=gain)


def downsample2d(x, f, down: int = 2, gain: float = 1.0):
    fh = f.shape[-1]
    p = fh - down
    return upfirdn2d(x, f, down=down,
                     padding=((p + 1) // 2, p // 2, (p + 1) // 2, p // 2),
                     gain=gain)
