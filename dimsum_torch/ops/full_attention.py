"""Softmax attention over a whole sequence, port of
`dimsum_tpu/ops/full_attention.py`: the attention of DiM at L = 1024 (the
512-px DiTBlock and CrossAttentionFusion), in the modules' (B, L, H, Dh)
layout.

  * `full_block_supported(L, Dh)`: the JAX package's gate.
  * `full_attention_ref`   : the plain version, what the Pallas
                             `_attn_kernel` computes.
  * `full_block_attention_cuda` : the hand-written CUDA kernels, each
                             launch-counted, the route fixed by dtype and
                             head size (`attention_kernel`): bf16 at Dh 64
                             and 72 (DiM-L/2's heads; DiT-XL/2's and
                             DiM-XL/2's) to `csrc/full_attention_sm90.cu`
                             (TMA + wgmma, `full_attention_sm90`), fp32 at Dh
                             64 and 72 to `csrc/full_attention_f32.cu` (S on
                             the FP32 pipe, P V as three TF32 tensor-core
                             products, `full_attention_f32`), the rest (bf16
                             and fp32 at Dh 80-128) to
                             `csrc/full_attention.cu`
                             (`full_attention_first`).
  * `full_block_attention` : the autograd Function the modules call: the
                             kernel for CUDA tensors, the plain version for
                             CPU tensors; its backward recomputes through the
                             plain version under autograd, as the JAX
                             `custom_vjp` recomputes through XLA (there is no
                             backward kernel in either package).
"""

from __future__ import annotations

import ctypes

import torch

from dimsum_torch.ops import cuda_build
from dimsum_torch.ops.cuda_build import DTYPE_CODE, needs_grad
from dimsum_torch.utils import remat

__all__ = ["full_block_supported", "full_attention_ref", "attention_kernel",
           "full_attention_sm90", "full_attention_f32", "full_attention_first",
           "full_block_attention_cuda", "full_block_attention",
           "FullBlockAttentionFn"]

# the JAX gate: S, exp(S) and P of one head fit the TPU's VMEM up to L 1024
_MAX_FULL_BLOCK_L = 1024
# the head sizes the kernels take (csrc/full_attention.cu is compiled for
# each; the Hopper redesigns for those of `_REDESIGN_HEAD_DIMS`)
_KERNEL_HEAD_DIMS = tuple(range(64, 129, 8))
_REDESIGN_HEAD_DIMS = (64, 72)
# csrc/full_attention.cu: q, k, v, out; the batch and row strides of q, k,
# v; B, L, H, Dh, dtype; the scale
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 6
             + [ctypes.c_int] * 5 + [ctypes.c_float])
# csrc/full_attention_sm90.cu and csrc/full_attention_f32.cu: q, k, v, out;
# the strides; B, L, H, Dh; the scale
_REDESIGN_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 6
                      + [ctypes.c_int] * 4 + [ctypes.c_float])


def full_block_supported(L: int, Dh: int) -> bool:
    """L a multiple of 128 and at most 1024, Dh a multiple of 8
    (full_attention.py:128-132)."""
    return L % 128 == 0 and L <= _MAX_FULL_BLOCK_L and Dh % 8 == 0


def attention_kernel(dtype: torch.dtype, Dh: int) -> str:
    """The route inside `full_block_attention_cuda`, fixed by dtype and head
    size before any launch: the name of the kernel (its source under
    `csrc/` and its launch-counted wrapper here) that takes the call.  bf16
    at Dh 64 and 72 to the TMA + wgmma kernel (`full_attention_sm90`), fp32
    at Dh 64 and 72 to `full_attention_f32`, all else (Dh 80-128, which no
    model of the zoo has) to the first design (`full_attention_first`).
    Not a fallback: each kernel raises on failure."""
    if Dh in _REDESIGN_HEAD_DIMS and dtype == torch.bfloat16:
        return "full_attention_sm90"
    if Dh in _REDESIGN_HEAD_DIMS and dtype == torch.float32:
        return "full_attention_f32"
    return "full_attention_first"


def full_attention_ref(q, k, v, sm_scale: float):
    """q, k, v: (B, L, H, Dh) -> (B, L, H, Dh) in q's dtype, as
    `_attn_kernel` computes it: q pre-scaled in q's dtype; S = q k^T in
    fp32; P = exp(S - rowmax); P rounded to v's dtype before P V (fp32
    sums); the result divided by the fp32 row sum of the unrounded P and
    cast to q's dtype.  Differentiable by autograd."""
    qs = q * torch.tensor(sm_scale, dtype=q.dtype, device=q.device)
    qt, kt, vt = (t.transpose(1, 2).float() for t in (qs, k, v))
    s = torch.matmul(qt, kt.transpose(-1, -2))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    denom = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), vt)
    return (o / denom).to(q.dtype).transpose(1, 2)


def _check(name, t, device, dtype, shape):
    """Device, dtype and shape; each (H, Dh) row packed; batch and row
    strides that keep every row 16-byte aligned."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.stride(3) != 1 or t.stride(2) != shape[3]:
        raise ValueError(f"{name}: each (heads, Dh) row must be contiguous")
    if t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16:
        raise ValueError(f"{name}: batch and row strides must be multiples "
                         "of 8 elements on a 16-byte aligned pointer")


def _redesign_launch(name, q, k, v, out, scale) -> None:
    """Launch a Hopper redesign, compiled for the head sizes of
    `_REDESIGN_HEAD_DIMS` alone: any other raises here."""
    B, L, H, Dh = q.shape
    if Dh not in _REDESIGN_HEAD_DIMS:
        raise NotImplementedError(
            f"{name} is built for Dh in {_REDESIGN_HEAD_DIMS}, got Dh={Dh}")
    cuda_build.check_tensor("out", out, q.device, q.dtype, q.shape)
    cuda_build.launch(name, _REDESIGN_ARGTYPES, q.device, q, k, v, out,
                      q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                      v.stride(0), v.stride(1), B, L, H, Dh, scale)


def full_attention_sm90(q, k, v, out, scale: float) -> None:
    """Launch `csrc/full_attention_sm90.cu` on bf16 tensors of Dh 64 or
    72 that `full_block_attention_cuda` has checked (q, k, v strided),
    writing `out` (contiguous), `scale` already rounded to bf16.  Counts
    its launches in `full_attention_sm90.launches`."""
    _redesign_launch("full_attention_sm90", q, k, v, out, scale)
    full_attention_sm90.launches += 1


def full_attention_f32(q, k, v, out, scale: float) -> None:
    """Launch `csrc/full_attention_f32.cu` on fp32 tensors of Dh 64 or 72
    that `full_block_attention_cuda` has checked, as `full_attention_sm90`
    does.  Counts its launches in `full_attention_f32.launches`."""
    _redesign_launch("full_attention_f32", q, k, v, out, scale)
    full_attention_f32.launches += 1


def full_attention_first(q, k, v, out, scale: float) -> None:
    """Launch `csrc/full_attention.cu` (the first design: any Dh in 64,
    72, ..., 128, fp32 or bf16) on tensors that `full_block_attention_cuda`
    has checked, as `full_attention_sm90` does.  Counts its launches in
    `full_attention_first.launches`."""
    B, L, H, Dh = q.shape
    cuda_build.check_tensor("out", out, q.device, q.dtype, q.shape)
    cuda_build.launch("full_attention", _ARGTYPES, q.device, q, k, v, out,
                      q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                      v.stride(0), v.stride(1), B, L, H, Dh,
                      DTYPE_CODE[q.dtype], scale)
    full_attention_first.launches += 1


full_attention_sm90.launches = 0
full_attention_f32.launches = 0
full_attention_first.launches = 0
_KERNELS = {fn.__name__: fn for fn in (full_attention_sm90, full_attention_f32,
                                       full_attention_first)}


def full_block_attention_cuda(q, k, v, sm_scale: float):
    """Launch a CUDA kernel on q, k, v: (B, L, H, Dh) CUDA tensors of one
    dtype (float32 or bfloat16), each (H, Dh) row contiguous (the batch and
    row strides are free, so slices of one qkv projection go in without a
    copy), with `full_block_supported(L, Dh)` and Dh in 64, 72, ..., 128:
    the kernel `attention_kernel(dtype, Dh)` names.  Returns a new
    contiguous (B, L, H, Dh) tensor.  Raises on anything else.  It has no
    backward: under grad mode with an input that requires grad it raises
    (the training route is `full_block_attention`)."""
    if needs_grad(q, k, v):
        raise RuntimeError(
            "full_block_attention_cuda has no backward; take "
            "full_block_attention or run under torch.no_grad()")
    if not q.is_cuda:
        raise ValueError("full_block_attention_cuda takes CUDA tensors only")
    if q.ndim != 4:
        raise ValueError(f"q must be (B, L, H, Dh), got {tuple(q.shape)}")
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"unsupported dtype {q.dtype}: float32 or bfloat16")
    B, L, H, Dh = q.shape
    if not full_block_supported(L, Dh) or Dh not in _KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"the full-block attention kernel takes L % 128 == 0, L <= "
            f"{_MAX_FULL_BLOCK_L} and Dh in {_KERNEL_HEAD_DIMS}; got L={L}, "
            f"Dh={Dh}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.device, q.dtype, (B, L, H, Dh))
    out = torch.empty(B, L, H, Dh, device=q.device, dtype=q.dtype)
    # the scale rounded to q's dtype, as the plain version multiplies by it
    scale = torch.tensor(sm_scale, dtype=q.dtype).item()
    _KERNELS[attention_kernel(q.dtype, Dh)](q, k, v, out, scale)
    full_block_attention_cuda.launches += 1
    return out


full_block_attention_cuda.launches = 0


class FullBlockAttentionFn(torch.autograd.Function):
    """Forward: the kernel for CUDA tensors, the plain version for CPU
    tensors.  Backward: recompute through `full_attention_ref` and
    differentiate that (the JAX `_bwd`, full_attention.py:118-122); only
    q, k and v are saved."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        ctx.sm_scale = sm_scale
        ctx.save_for_backward(q, k, v)
        fn = full_block_attention_cuda if q.is_cuda else full_attention_ref
        # a remat site (attn_out), as the scan's Function is (scan_out)
        return remat.kernel_outputs("attn_out",
                                    lambda: fn(q, k, v, sm_scale))

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = full_attention_ref(*leaves, ctx.sm_scale)
            dq, dk, dv = torch.autograd.grad(out, leaves, g)
        return dq, dk, dv, None


def full_block_attention(q, k, v, sm_scale: float):
    """Softmax attention, (B, L, H, Dh) in and out (the module layout), the
    JAX `full_block_attention`.  CUDA tensors go to the kernel (or the call
    raises), CPU tensors to the plain version; differentiable."""
    return FullBlockAttentionFn.apply(q, k, v, sm_scale)
