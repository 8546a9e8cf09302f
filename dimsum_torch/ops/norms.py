"""Norms, fused residual add + norm, and adaLN modulation: the composition
of `dimsum_tpu/ops/norms.py` (:184-262, :391-443) with its dtype rules,
and the ports of its two norm kernels.

  * the norm math runs in fp32 and the result is cast back;
  * `fused_add_norm` adds the residual in fp32 and carries the sum in fp32
    (`residual_in_fp32`) or in the input dtype;
  * `norm_modulate` without a residual adds `gate * branch` in the input
    dtype; with one it accumulates in fp32; `total` is emitted in
    `total_dtype` (default: the input dtype).

The kernels, each behind a switch as in the JAX package (`kernel=` /
`fuse=`, the model's `pallas_norm` / `fused_norm`), and each taken only
where the JAX gate's shape test holds (`add_norm_supported`,
`norm_modulate_supported`); elsewhere the composition runs:

  * `add_norm_ref` / `add_norm_cuda` / `AddNormFn`: the Pallas
    `_add_norm_kernel` (csrc/add_norm.cu), total = x + res in fp32, then
    Norm * w (+ b); the analytic backward of `_add_norm_bwd`.
  * `norm_modulate_ref` / `norm_modulate_cuda` / `NormModulateFn`: the
    Pallas `_norm_mod_kernel` (csrc/norm_modulate.cu), total = base (+ gate
    * branch) (+ res) summed in fp32 and rounded once, Norm * w (+ b), then
    out * (1 + scale) + shift in the out dtype; the backward recomputes
    through the plain version, as `_norm_mod_bwd` does with `jax.vjp`.

The Functions take the kernel for CUDA tensors (or raise) and the plain
version for CPU tensors; `impl="ref"` takes the plain version on any
device, which checks hold the kernels against.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from dimsum_torch.ops import cuda_build
from dimsum_torch.ops.cuda_build import DTYPE_CODE, needs_grad

__all__ = ["rms_norm", "layer_norm", "fused_add_norm", "modulate",
           "norm_modulate", "add_norm_supported", "add_norm_ref",
           "add_norm_cuda", "AddNormFn", "norm_modulate_supported",
           "norm_modulate_ref", "norm_modulate_cuda", "NormModulateFn"]

_MAX_D = 4096  # the JAX gates' widest row
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# x, res, w, b, out, total; rows, D, dtype, is_rms; eps
_ADD_NORM_ARGS = [_P] * 6 + [_I] * 4 + [ctypes.c_float]
# base, branch, gate, res, w, b, shift, scale, out, total; the per-batch
# row strides of gate, shift, scale; rows, L, D, dtype, total_f32, is_rms;
# eps
_NORM_MOD_ARGS = [_P] * 10 + [_L] * 3 + [_I] * 6 + [ctypes.c_float]


def rms_norm(x, weight, bias=None, eps: float = 1e-5):
    xf = x.float()
    rstd = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    out = xf * rstd * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def layer_norm(x, weight=None, bias=None, eps: float = 1e-6):
    """LayerNorm in fp32; weight/bias may be None (no affine, the DiT
    blocks' norms)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def _pick_rows(n_rows: int) -> int:
    """The JAX `_pick_rows`: the largest row tile of 512 ... 8 dividing
    `n_rows`, 0 if none does."""
    for cand in (512, 256, 128, 64, 32, 16, 8):
        if n_rows % cand == 0:
            return cand
    return 0


def _row_width_ok(d: int) -> bool:
    return d % 128 == 0 and d <= _MAX_D


def _normalize(total, eps: float, is_rms: bool):
    """fp32 RMS or LayerNorm (two passes: mean, then the centred
    variance) of an fp32 tensor over its last axis."""
    if is_rms:
        return total * torch.rsqrt(total.square().mean(-1, keepdim=True)
                                   + eps)
    mean = total.mean(-1, keepdim=True)
    var = (total - mean).square().mean(-1, keepdim=True)
    return (total - mean) * torch.rsqrt(var + eps)


def _check(name, t, device, dtype, shape, strided_rows: bool = False):
    """Device, dtype, shape, contiguity and a 16-byte aligned pointer (the
    kernels load rows as 8- and 16-byte vectors of 4 values).  With
    `strided_rows` a 2-D tensor's rows may lie apart, at a stride of a
    multiple of 4 values."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    packed = (t.stride(-1) == 1 and t.stride(0) % 4 == 0
              if strided_rows else t.is_contiguous())
    if not packed or t.data_ptr() % (4 * t.element_size()):
        raise ValueError(f"{name} must be contiguous (each row, when rows "
                         "may lie apart) and aligned to 4 values")


def _kernel_width(name, d):
    if not _row_width_ok(d):
        raise NotImplementedError(
            f"{name} takes rows of D % 128 == 0 and D <= {_MAX_D}; got D={d}")


# ---------------------------------------------------------------------------
# Kernel 5: add + norm (the Pallas `_add_norm_kernel`)
# ---------------------------------------------------------------------------

def add_norm_supported(x) -> bool:
    """The shape part of the JAX gate `_add_norm_pallas_ok`
    (norms.py:156-160): D % 128 == 0, D <= 4096, and the rows a multiple
    of 8."""
    rows = 1
    for s in x.shape[:-1]:
        rows *= s
    return (x.ndim >= 2 and _row_width_ok(x.shape[-1])
            and _pick_rows(rows) > 0)


def add_norm_ref(x2, res2, w, b, eps: float, is_rms: bool, out_dtype):
    """What `_add_norm_kernel` computes (norms.py:35-54): x2, res2 (rows,
    D); w, b (D,) (b may be None).  total = x + res in fp32; out =
    Norm(total) * w (+ b) in `out_dtype`.  Returns (out, total fp32)."""
    total = x2.float() + res2.float()
    out = _normalize(total, eps, is_rms) * w.float()
    if b is not None:
        out = out + b.float()
    return out.to(out_dtype), total


def add_norm_cuda(x2, res2, w, b=None, eps: float = 1e-5,
                  is_rms: bool = True):
    """Launch kernel 5 on CUDA tensors: x2 (rows, D) float32 or bfloat16,
    res2 (rows, D) float32, w and b (D,) float32 (b may be None), all
    contiguous, with D % 128 == 0 and D <= 4096.  Returns (out in x2's
    dtype, total float32).  Raises on anything else, and under grad mode
    with an input that requires grad (the training route is
    `AddNormFn`)."""
    if needs_grad(x2, res2, w, b):
        raise RuntimeError("add_norm_cuda has no backward; take AddNormFn "
                           "or run under torch.no_grad()")
    if not x2.is_cuda:
        raise ValueError("add_norm_cuda takes CUDA tensors only")
    if x2.ndim != 2 or x2.dtype not in DTYPE_CODE:
        raise TypeError(f"x2 must be (rows, D) float32 or bfloat16, got "
                        f"{tuple(x2.shape)} {x2.dtype}")
    rows, d = x2.shape
    _kernel_width("add_norm_cuda", d)
    dev = x2.device
    _check("x2", x2, dev, x2.dtype, (rows, d))
    _check("res2", res2, dev, torch.float32, (rows, d))
    _check("w", w, dev, torch.float32, (d,))
    if b is not None:
        _check("b", b, dev, torch.float32, (d,))
    out = torch.empty_like(x2)
    total = torch.empty((rows, d), device=dev, dtype=torch.float32)
    cuda_build.launch("add_norm", _ADD_NORM_ARGS, dev, x2, res2, w, b, out,
                      total, rows, d, DTYPE_CODE[x2.dtype], int(bool(is_rms)),
                      float(eps))
    add_norm_cuda.launches += 1
    return out, total


add_norm_cuda.launches = 0


class AddNormFn(torch.autograd.Function):
    """Forward: kernel 5 for CUDA tensors, `add_norm_ref` for CPU tensors.
    Backward: the analytic RMS/LayerNorm backward of `_add_norm_bwd`
    (norms.py:108-136) in plain PyTorch (XLA in the JAX package); x and
    res receive the same cotangent, plus the one of `total`."""

    @staticmethod
    def forward(ctx, x2, res2, w, b, eps, is_rms):
        if x2.is_cuda:
            out, total = add_norm_cuda(x2, res2, w, b, eps, is_rms)
        else:
            out, total = add_norm_ref(x2, res2, w, b, eps, is_rms, x2.dtype)
        ctx.eps, ctx.is_rms = eps, is_rms
        ctx.dtypes = (x2.dtype, res2.dtype, None if b is None else b.dtype)
        ctx.save_for_backward(total, w)
        return out, total

    @staticmethod
    def backward(ctx, g_out, g_total):
        total, w = ctx.saved_tensors
        x_dt, res_dt, b_dt = ctx.dtypes
        g = g_out.float()
        if ctx.is_rms:
            r = torch.rsqrt(total.square().mean(-1, keepdim=True) + ctx.eps)
            xhat = total * r
        else:
            mean = total.mean(-1, keepdim=True)
            var = (total - mean).square().mean(-1, keepdim=True)
            r = torch.rsqrt(var + ctx.eps)
            xhat = (total - mean) * r
        gy = g * w.float()
        m1 = (gy * xhat).mean(-1, keepdim=True)
        if ctx.is_rms:
            dt = r * (gy - xhat * m1)
        else:
            dt = r * (gy - gy.mean(-1, keepdim=True) - xhat * m1)
        if g_total is not None:
            dt = dt + g_total.float()
        dw = (g * xhat).sum(0).to(w.dtype)
        db = None if b_dt is None else g.sum(0).to(b_dt)
        return dt.to(x_dt), dt.to(res_dt), dw, db, None, None


def fused_add_norm(x, weight, bias=None, residual=None, eps: float = 1e-5,
                   prenorm: bool = True, residual_in_fp32: bool = True,
                   is_rms: bool = True, kernel: bool = False,
                   impl: Optional[str] = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """residual' = x + residual; out = Norm(residual').  Returns
    (out, residual') when prenorm, else out.

    With `kernel` (the JAX `DIMSUM_PALLAS_NORM`), a site with a residual and
    a weight whose shape passes `add_norm_supported` takes kernel 5 through
    `AddNormFn` (`impl="ref"`: its plain version), as norms.py:235-245
    routes; every other site takes the composition."""
    if impl not in (None, "ref"):
        raise ValueError(f"unknown norm impl {impl!r}")
    if (kernel and residual is not None and weight is not None
            and add_norm_supported(x)):
        d = x.shape[-1]
        x2, res2 = x.reshape(-1, d), residual.reshape(-1, d)
        if impl == "ref":
            out, total = add_norm_ref(x2, res2, weight, bias, eps, is_rms,
                                      x.dtype)
        else:
            out, total = AddNormFn.apply(x2, res2, weight, bias, eps, is_rms)
        out, total = out.reshape(x.shape), total.reshape(x.shape)
    else:
        total = x.float() if residual is None else x.float() + residual.float()
        norm_fn = rms_norm if is_rms else layer_norm
        out = norm_fn(total, weight, bias, eps=eps).to(x.dtype)
    if not prenorm:
        return out
    return out, (total if residual_in_fp32 else total.to(x.dtype))


def modulate(x, shift, scale):
    """x * (1 + scale) + shift with per-batch (N, D) vectors."""
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


# ---------------------------------------------------------------------------
# Kernel 6: (gate-add +) add + norm + modulate (the Pallas
# `_norm_mod_kernel`)
# ---------------------------------------------------------------------------

def norm_modulate_supported(x) -> bool:
    """The shape part of the JAX gate `_fused_norm_mod_ok`
    (norms.py:383-388): (B, L, D) with D % 128 == 0, D <= 4096, and a row
    tile of 8 or more dividing L."""
    if x.ndim != 3 or not _row_width_ok(x.shape[-1]):
        return False
    t = _pick_rows(min(x.shape[0] * x.shape[1], x.shape[1]))
    while t and x.shape[1] % t:
        t //= 2
    return t > 0


def norm_modulate_ref(x, weight=None, bias=None, branch=None, gate=None,
                      residual=None, shift=None, scale=None,
                      eps: float = 1e-5, is_rms: bool = True,
                      total_dtype=None):
    """What `_norm_mod_kernel` computes, as the JAX `_norm_mod_xla_2d`
    (norms.py:476-512) states it, on (B, L, D) and per-batch (B, D)
    operands: total = x (+ gate * branch) (+ residual) summed in fp32 and
    emitted in `total_dtype` (default x's); the norm reads that rounded
    total; Norm * weight (+ bias) in x's dtype; then, with shift and scale,
    out * (1 + scale) + shift in x's dtype.  Returns (out, total).
    Differentiable by autograd."""
    out_dtype = x.dtype
    total_dtype = total_dtype or x.dtype
    total = x.float()
    if branch is not None:
        br = branch.float()
        if gate is not None:
            br = gate.float()[:, None, :] * br
        total = total + br
    if residual is not None:
        total = total + residual.float()
    total_out = total.to(total_dtype)
    normed = _normalize(total_out.float(), eps, is_rms)
    if weight is not None:
        normed = normed * weight.float()
    if bias is not None:
        normed = normed + bias.float()
    out = normed.to(out_dtype)
    if shift is not None:
        out = modulate(out, shift, scale)
    return out, total_out


def norm_modulate_cuda(x, weight=None, bias=None, branch=None, gate=None,
                       residual=None, shift=None, scale=None,
                       eps: float = 1e-5, is_rms: bool = True,
                       total_dtype=None):
    """Launch kernel 6 on CUDA tensors: `norm_modulate_ref`'s function.
    x, branch (B, L, D) and gate, shift, scale (B, D) in one dtype
    (float32 or bfloat16); residual (B, L, D), weight and bias (D,) in
    float32; any of them but x may be None (shift and scale together);
    `total_dtype` float32 or x's dtype; all contiguous, except that the rows
    of gate, shift and scale may lie apart (adaLN chunks); x, branch and
    residual 16-byte aligned; D % 128 == 0 and D <= 4096.  Returns new
    (out, total).  Raises on anything else, and under grad mode with an
    input that requires grad (the training route is `NormModulateFn`)."""
    tensors = (x, branch, gate, residual, weight, bias, shift, scale)
    if needs_grad(*tensors):
        raise RuntimeError("norm_modulate_cuda has no backward; take "
                           "NormModulateFn or run under torch.no_grad()")
    if not x.is_cuda:
        raise ValueError("norm_modulate_cuda takes CUDA tensors only")
    if x.ndim != 3 or x.dtype not in DTYPE_CODE:
        raise TypeError(f"x must be (B, L, D) float32 or bfloat16, got "
                        f"{tuple(x.shape)} {x.dtype}")
    if (shift is None) != (scale is None):
        raise ValueError("shift and scale come together")
    if gate is not None and branch is None:
        raise ValueError("a gate needs a branch")
    B, L, D = x.shape
    _kernel_width("norm_modulate_cuda", D)
    total_dtype = total_dtype or x.dtype
    if total_dtype not in (torch.float32, x.dtype):
        raise TypeError(f"total_dtype must be float32 or {x.dtype}")
    dev, dt = x.device, x.dtype
    _check("x", x, dev, dt, (B, L, D))
    for name, t, dtype, shape in (
            ("branch", branch, dt, (B, L, D)),
            ("residual", residual, torch.float32, (B, L, D)),
            ("weight", weight, torch.float32, (D,)),
            ("bias", bias, torch.float32, (D,))):
        if t is not None:
            _check(name, t, dev, dtype, shape)
    for name, t in (("gate", gate), ("shift", shift), ("scale", scale)):
        if t is not None:
            _check(name, t, dev, dt, (B, D), strided_rows=True)
    for name, t in (("x", x), ("branch", branch), ("residual", residual)):
        if t is not None and t.data_ptr() % 16:  # the kernel's bulk copies
            raise ValueError(f"{name} must be aligned to 16 bytes")
    out = torch.empty_like(x)
    total = torch.empty((B, L, D), device=dev, dtype=total_dtype)
    strides = [0 if t is None else t.stride(0) for t in (gate, shift, scale)]
    cuda_build.launch("norm_modulate", _NORM_MOD_ARGS, dev, *tensors, out,
                      total, *strides, B * L, L, D, DTYPE_CODE[dt],
                      int(total_dtype == torch.float32), int(bool(is_rms)),
                      float(eps))
    norm_modulate_cuda.launches += 1
    return out, total


norm_modulate_cuda.launches = 0


class NormModulateFn(torch.autograd.Function):
    """Forward: kernel 6 for CUDA tensors, `norm_modulate_ref` for CPU
    tensors.  Backward: recompute through `norm_modulate_ref` under
    autograd and differentiate that (`_norm_mod_bwd`, norms.py:523-532)."""

    @staticmethod
    def forward(ctx, x, weight, bias, branch, gate, residual, shift, scale,
                eps, is_rms, total_dtype):
        fn = norm_modulate_cuda if x.is_cuda else norm_modulate_ref
        out, total = fn(x, weight, bias, branch, gate, residual, shift,
                        scale, eps, is_rms, total_dtype)
        ctx.args = (eps, is_rms, total_dtype)
        ctx.save_for_backward(x, weight, bias, branch, gate, residual,
                              shift, scale)
        return out, total

    @staticmethod
    def backward(ctx, g_out, g_total):
        saved = ctx.saved_tensors
        leaves = [None if t is None else t.detach().requires_grad_(True)
                  for t in saved]
        with torch.enable_grad():
            out, total = norm_modulate_ref(*leaves, *ctx.args)
            wrt = [t for t in leaves if t is not None]
            grads = iter(torch.autograd.grad((out, total), wrt,
                                             (g_out, g_total),
                                             allow_unused=True))
        return (*[None if t is None else next(grads) for t in leaves],
                None, None, None)


def norm_modulate(x, weight, bias=None, *, branch=None, gate=None,
                  residual=None, shift=None, scale=None, eps: float = 1e-5,
                  is_rms: bool = True, total_dtype=None, fuse: bool = False,
                  impl: Optional[str] = None):
    """total = x (+ gate*branch) (+ residual); out = modulate(Norm(total)).
    Returns (out, total).

    With `fuse` (the JAX `DIMSUM_FUSED_NORM`, or `fuse=True` at a call
    site), a shape that passes `norm_modulate_supported` takes kernel 6
    through `NormModulateFn` (`impl="ref"`: its plain version); otherwise
    the composition runs, which without a residual adds in the input dtype
    where the kernel adds in fp32 and rounds once."""
    if impl not in (None, "ref"):
        raise ValueError(f"unknown norm impl {impl!r}")
    if fuse and norm_modulate_supported(x):
        fn = norm_modulate_ref if impl == "ref" else NormModulateFn.apply
        return fn(x, weight, bias, branch, gate, residual, shift, scale,
                  eps, is_rms, total_dtype)
    out_dtype = x.dtype
    total_dtype = total_dtype or x.dtype
    if residual is None:
        total = x
        if branch is not None:
            br = branch if gate is None else gate[:, None, :] * branch
            total = total + br
    else:
        ct = torch.promote_types(x.dtype, torch.float32)
        total = x.to(ct)
        if branch is not None:
            br = branch.to(ct)
            if gate is not None:
                br = gate.to(ct)[:, None, :] * br
            total = total + br
        total = total + residual.to(ct)
    total = total.to(total_dtype)
    norm_fn = rms_norm if is_rms else layer_norm
    out = norm_fn(total, weight, bias, eps=eps).to(out_dtype)
    if shift is not None:
        out = modulate(out, shift, scale)
    return out, total
