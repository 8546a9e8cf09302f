"""Norms, fused residual add + norm, and adaLN modulation: the composition
of `dimsum_tpu/ops/norms.py` (:184-262, :391-443) with its dtype rules.

  * the norm math runs in fp32 and the result is cast back;
  * `fused_add_norm` adds the residual in fp32 and carries the sum in fp32
    (`residual_in_fp32`) or in the input dtype;
  * `norm_modulate` without a residual adds `gate * branch` in the input
    dtype; with one it accumulates in fp32; `total` is emitted in
    `total_dtype` (default: the input dtype).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["rms_norm", "layer_norm", "fused_add_norm", "modulate",
           "norm_modulate"]


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


def fused_add_norm(x, weight, bias=None, residual=None, eps: float = 1e-5,
                   prenorm: bool = True, residual_in_fp32: bool = True,
                   is_rms: bool = True
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """residual' = x + residual; out = Norm(residual').  Returns
    (out, residual') when prenorm, else out."""
    total = x.float() if residual is None else x.float() + residual.float()
    norm_fn = rms_norm if is_rms else layer_norm
    out = norm_fn(total, weight, bias, eps=eps).to(x.dtype)
    if not prenorm:
        return out
    return out, (total if residual_in_fp32 else total.to(x.dtype))


def modulate(x, shift, scale):
    """x * (1 + scale) + shift with per-batch (N, D) vectors."""
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def norm_modulate(x, weight, bias=None, *, branch=None, gate=None,
                  residual=None, shift=None, scale=None, eps: float = 1e-5,
                  is_rms: bool = True, total_dtype=None):
    """total = x (+ gate*branch) (+ residual); out = modulate(Norm(total)).
    Returns (out, total)."""
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
