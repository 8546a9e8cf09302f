"""Fused depthwise causal conv + SiLU + x_proj: port of
`dimsum_tpu/ops/conv_xproj.py`, the mixer's conv prologue with the JAX
switch `DIMSUM_CONV_XPROJ` (the model's `conv_xproj`).

    x_conv = silu(causal_conv1d(x, conv_w) + conv_b)      x's dtype
    x_dbl  = x_conv @ w_xp^T                              fp32 sums

  * `conv_xproj_supported(x, R)`: the shape part of the JAX gate.
  * `conv_xproj_ref`   : the plain version, the composition the Pallas
                         `_kernel` replaces (`conv_xproj_ref`, :44-50).
  * `conv_xproj_cuda`  : the hand-written CUDA kernel
                         (`csrc/conv_xproj.cu`), launch-counted.
  * `ConvXProjFn`      : the autograd Function: the kernel for CUDA
                         tensors, the plain version for CPU tensors; its
                         backward recomputes through the plain version under
                         autograd, as the JAX `_bwd` (:153-158) does.
  * `conv_xproj`       : the entry point the mixer calls.

`w_xp` is `x_proj.weight` in the torch layout (R, D); it is cast to x's
dtype before the product (`w_xp.astype(x.dtype)` in the JAX package), so
a float32 training weight receives its gradient through the cast.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dimsum_torch.ops import cuda_build
from dimsum_torch.ops.causal_conv1d import causal_conv1d
from dimsum_torch.ops.cuda_build import DTYPE_CODE, check_tensor, needs_grad
from dimsum_torch.utils import remat

__all__ = ["conv_xproj_supported", "conv_xproj_ref", "conv_xproj_cuda",
           "ConvXProjFn", "conv_xproj"]

_MAX_R = 512        # the JAX gate's widest x_proj
_KERNEL_CHAN = 64   # channels per chunk in csrc/conv_xproj.cu
_KERNEL_MAX_W = 8   # conv widths the kernel's halo holds
# x, conv_w, conv_b, w_xp, x_conv, x_dbl; x's batch and row strides;
# B, L, D, W, R, dtype, reverse
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
             + [ctypes.c_int] * 7)


def conv_xproj_supported(x, R: int) -> bool:
    """The shape part of the JAX gate (conv_xproj.py:53-59): x (B, L, D)
    with D % 128 == 0, R <= 512, and one (L, max(D, 512)) fp32 tile within
    8 MiB."""
    _, L, D = x.shape
    return D % 128 == 0 and R <= _MAX_R and L * max(D, 512) * 4 <= 8 * 2**20


def _tma_readable(x) -> bool:
    """The kernel reads x through a TMA tensor map: its address must be
    16-byte aligned and its batch and row strides multiples of 16 bytes
    (8 bf16 or 4 fp32 elements)."""
    per16 = 16 // x.element_size()
    return (x.data_ptr() % 16 == 0 and x.stride(0) % per16 == 0
            and x.stride(1) % per16 == 0)


def conv_xproj_ref(x, conv_w, conv_b, w_xp, reverse: bool = False):
    """x (B, L, D); conv_w (D, W); conv_b (D,) or None; w_xp (R, D).
    Returns (x_conv (B, L, D) in x's dtype, x_dbl (B, L, R) fp32): the
    conv, bias and SiLU in fp32 (`causal_conv1d`), then x_conv times w_xp
    rounded to x's dtype, the products summed in fp32.  Differentiable by
    autograd."""
    x_conv = causal_conv1d(x, conv_w, conv_b, activation="silu",
                           reverse=reverse)
    x_dbl = torch.matmul(x_conv.float(), w_xp.to(x.dtype).float().t())
    return x_conv, x_dbl


def conv_xproj_cuda(x, conv_w, conv_b, w_xp, reverse: bool = False):
    """Launch the CUDA kernel: `conv_xproj_ref`'s function.  x (B, L, D) a
    CUDA tensor of float32 or bfloat16 whose channels are contiguous (the
    batch and row strides are free, so the first half of `in_proj`'s output
    goes in without a copy; an x whose address or strides TMA cannot take
    is copied first); conv_w (D, W) and conv_b (D,) float32 contiguous
    (conv_b may be None); w_xp (R, D), cast to x's dtype here.  D % 64 == 0
    and W <= 8.  Returns new contiguous (x_conv, x_dbl).  Raises on
    anything else, and under grad mode with an input that requires grad
    (the training route is `ConvXProjFn`).  `launches` counts every launch,
    `reverse_launches` the anticausal ones, `fp32_launches` those of the
    fp32 route."""
    if needs_grad(x, conv_w, conv_b, w_xp):
        raise RuntimeError("conv_xproj_cuda has no backward; take "
                           "ConvXProjFn or run under torch.no_grad()")
    if not x.is_cuda:
        raise ValueError("conv_xproj_cuda takes CUDA tensors only")
    if x.ndim != 3 or x.dtype not in DTYPE_CODE:
        raise TypeError(f"x must be (B, L, D) float32 or bfloat16, got "
                        f"{tuple(x.shape)} {x.dtype}")
    B, L, D = x.shape
    W, R = conv_w.shape[-1], w_xp.shape[0]
    if D % _KERNEL_CHAN or not 1 <= W <= _KERNEL_MAX_W or R < 1:
        raise NotImplementedError(
            f"the conv + x_proj kernel takes D % {_KERNEL_CHAN} == 0 and "
            f"1 <= W <= {_KERNEL_MAX_W}; got D={D}, W={W}, R={R}")
    if x.stride(2) != 1:
        raise ValueError("x: the channels of each row must be contiguous")
    if not _tma_readable(x):
        x = x.contiguous()
    dev = x.device
    check_tensor("conv_w", conv_w, dev, torch.float32, (D, W))
    if conv_b is not None:
        check_tensor("conv_b", conv_b, dev, torch.float32, (D,))
    w = w_xp.to(x.dtype).contiguous()
    check_tensor("w_xp", w, dev, x.dtype, (R, D))
    x_conv = torch.empty((B, L, D), device=dev, dtype=x.dtype)
    x_dbl = torch.empty((B, L, R), device=dev, dtype=torch.float32)
    cuda_build.launch("conv_xproj", _ARGTYPES, dev, x, conv_w, conv_b, w,
                      x_conv, x_dbl, x.stride(0), x.stride(1), B, L, D, W, R,
                      DTYPE_CODE[x.dtype], int(bool(reverse)))
    conv_xproj_cuda.launches += 1
    conv_xproj_cuda.reverse_launches += bool(reverse)
    conv_xproj_cuda.fp32_launches += x.dtype == torch.float32
    return x_conv, x_dbl


conv_xproj_cuda.launches = 0
conv_xproj_cuda.reverse_launches = 0
conv_xproj_cuda.fp32_launches = 0


class ConvXProjFn(torch.autograd.Function):
    """Forward: the kernel for CUDA tensors, the plain version for CPU
    tensors.  Backward: recompute through `conv_xproj_ref` and
    differentiate that; only the inputs are saved."""

    @staticmethod
    def forward(ctx, x, conv_w, conv_b, w_xp, reverse):
        ctx.reverse = reverse
        ctx.save_for_backward(x, conv_w, conv_b, w_xp)
        fn = conv_xproj_cuda if x.is_cuda else conv_xproj_ref
        # a remat site (conv_out), as the scan's Function is (scan_out)
        return remat.kernel_outputs(
            "conv_out", lambda: fn(x, conv_w, conv_b, w_xp, reverse))

    @staticmethod
    def backward(ctx, g_conv, g_dbl):
        leaves = [None if t is None else t.detach().requires_grad_(True)
                  for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = conv_xproj_ref(*leaves, ctx.reverse)
            wrt = [t for t in leaves if t is not None]
            grads = iter(torch.autograd.grad(outs, wrt, (g_conv, g_dbl)))
        return (*[None if t is None else next(grads) for t in leaves], None)


def conv_xproj(x, conv_w, conv_b, w_xp, reverse: bool = False,
               impl: Optional[str] = None):
    """The JAX `conv_xproj`: (x_conv, x_dbl fp32), differentiable.  `impl`
    None takes the kernel for CUDA tensors (or raises) and the plain
    version for CPU tensors; "ref" the plain version on any device."""
    if impl == "ref":
        with remat.tag("conv_out"):
            return conv_xproj_ref(x, conv_w, conv_b, w_xp, reverse)
    if impl is not None:
        raise ValueError(f"unknown conv_xproj impl {impl!r}")
    return ConvXProjFn.apply(x, conv_w, conv_b, w_xp, reverse)
