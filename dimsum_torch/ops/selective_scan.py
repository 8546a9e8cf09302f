"""Selective scan (Mamba S6 recurrence), PyTorch port of
`dimsum_tpu/ops/selective_scan.py`.

Per batch b and channel d:

    dt      = softplus(delta + delta_bias)                  (optional)
    h_t     = exp(dt_t * A) * h_{t-1} + dt_t * u_t * B_t
    y_t     = <C_t, h_t> + D * u_t
    out_t   = y_t * silu(z_t)                               (optional gate)

Layout as in the JAX package: u, delta, z (batch, L, dim); B, C
(batch, L, N) or grouped (batch, L, G, N); A (dim, N); D, delta_bias (dim,).

  * `selective_scan_ref`   : the plain sequential fp32 recurrence.
  * `selective_scan_cuda`  : the hand-written CUDA kernel
                             (`csrc/selective_scan_fwd.cu`), the port of the
                             Pallas `_scan_body`, with delta = dt_low @ dt_w
                             expanded in the kernel.
  * `selective_scan_dtlow` : the front end the mixer calls.  CPU tensors take
                             the plain version, CUDA tensors the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

__all__ = ["selective_scan_ref", "selective_scan_cuda", "selective_scan_dtlow"]


def softplus(x):
    """log(1 + exp(x)) without overflow, the form jax.nn.softplus computes
    (F.softplus returns x itself above its threshold of 20)."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def _expand_groups(B, dim: int):
    """Grouped B/C (batch, L, G, N) -> per-channel (batch, L, dim, N); each
    group drives dim/G contiguous channels.  (batch, L, N) passes through."""
    if B.ndim == 3:
        return B
    return B.repeat_interleave(dim // B.shape[2], dim=2)


def selective_scan_ref(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                       delta_softplus=False, return_last_state=False):
    """Sequential fp32 recurrence (mirrors the JAX `selective_scan_ref`).
    The output is in u's dtype; the last state is (batch, dim, N) fp32."""
    dtype_in = u.dtype
    batch, L, dim = u.shape
    uf = u.float()
    dt = delta.float()
    if delta_bias is not None:
        dt = dt + delta_bias.float()
    if delta_softplus:
        dt = softplus(dt)
    Af = A.float()
    grouped = B.ndim == 4
    Bf = _expand_groups(B, dim).float()
    Cf = _expand_groups(C, dim).float()
    du = dt * uf
    h = torch.zeros(batch, dim, A.shape[1], dtype=torch.float32,
                    device=u.device)
    ys = []
    for t in range(L):
        a_t = torch.exp(dt[:, t, :, None] * Af)
        b_t = Bf[:, t] if grouped else Bf[:, t, None, :]
        h = a_t * h + du[:, t, :, None] * b_t
        c_t = Cf[:, t] if grouped else Cf[:, t, None, :]
        ys.append((h * c_t).sum(-1))
    out = torch.stack(ys, dim=1)
    if D is not None:
        out = out + uf * D.float()
    if z is not None:
        zf = z.float()
        out = out * (zf * torch.sigmoid(zf))
    out = out.to(dtype_in)
    return (out, h) if return_last_state else out


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_STATE, _MAX_RANK = 32, 64


def _library():
    from dimsum_torch.ops import cuda_build

    lib = cuda_build.load("selective_scan_fwd")
    fn = lib.dimsum_selective_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, device, dtype, shape):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def selective_scan_cuda(u, dt_low, dt_w, A, B, C, D=None, z=None,
                        delta_bias=None, delta_softplus=False):
    """Launch the CUDA kernel: selective_scan(u, dt_low @ dt_w, ...) with
    the dt expansion, bias and softplus in fp32 inside the kernel.

    u, z: (batch, L, dim); dt_low: (batch, L, r); dt_w: (r, dim); B, C:
    (batch, L, N) -- all contiguous, on one CUDA device, in one dtype
    (float32 or bfloat16).  A: (dim, N), D and delta_bias: (dim,), float32.
    Raises on anything else; grouped B/C is not implemented here."""
    if not u.is_cuda:
        raise ValueError("selective_scan_cuda takes CUDA tensors only")
    if B.ndim != 3 or C.ndim != 3:
        raise NotImplementedError(
            "grouped B/C is not implemented in the CUDA selective scan")
    if u.ndim != 3 or dt_low.ndim != 3 or dt_w.ndim != 2 or A.ndim != 2:
        raise ValueError("u, dt_low: (batch, L, ·); dt_w, A: 2-D")
    batch, L, dim = u.shape
    rank, n_state = dt_w.shape[0], A.shape[1]
    if u.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {u.dtype}: float32 or bfloat16")
    if not (1 <= n_state <= _MAX_STATE and 1 <= rank <= _MAX_RANK):
        raise NotImplementedError(
            f"CUDA selective scan takes 1 <= N <= {_MAX_STATE} and "
            f"1 <= dt_rank <= {_MAX_RANK}; got N={n_state}, r={rank}")
    dev, dt = u.device, u.dtype
    _check("u", u, dev, dt, (batch, L, dim))
    _check("dt_low", dt_low, dev, dt, (batch, L, rank))
    _check("dt_w", dt_w, dev, dt, (rank, dim))
    _check("A", A, dev, torch.float32, (dim, n_state))
    _check("B", B, dev, dt, (batch, L, n_state))
    _check("C", C, dev, dt, (batch, L, n_state))
    if D is not None:
        _check("D", D, dev, torch.float32, (dim,))
    if z is not None:
        _check("z", z, dev, dt, (batch, L, dim))
    if delta_bias is not None:
        _check("delta_bias", delta_bias, dev, torch.float32, (dim,))

    fn = _library()
    out = torch.empty_like(u)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ptr(u), ptr(dt_low), ptr(dt_w), ptr(A), ptr(B), ptr(C),
                ptr(D), ptr(z), ptr(delta_bias), ptr(out), batch, L, dim,
                n_state, rank, _DTYPE_CODE[dt], int(bool(delta_softplus)),
                stream)
    if rc != 0:
        raise RuntimeError(
            f"selective_scan_fwd launch failed: CUDA error {rc}")
    selective_scan_cuda.launches += 1
    return out


selective_scan_cuda.launches = 0


def _flip(v):
    return None if v is None else v.flip(1)


def selective_scan_dtlow(u, dt_low, dt_w, A, B, C, D=None, z=None,
                         delta_bias=None, delta_softplus=False,
                         reverse: bool = False, impl: Optional[str] = None):
    """selective_scan(u, dt_low @ dt_w, ...), the JAX `selective_scan_dtlow`.

    `dt_low` (batch, L, r) is the dt_proj input and `dt_w` (r, dim) its
    weight; the expansion is computed in fp32 (as the Pallas kernel does on
    its MXU).  `reverse=True` computes flip_L(scan(flip_L(inputs))).

    `impl`: None takes the CUDA kernel for CUDA tensors and the plain
    version for CPU tensors; "ref" takes the plain version on any device;
    "cuda" takes the kernel and raises for CPU tensors."""
    if impl is None:
        impl = "cuda" if u.is_cuda else "ref"
    if reverse:
        u, dt_low, B, C, z = (_flip(u), _flip(dt_low), _flip(B), _flip(C),
                              _flip(z))
    if impl == "cuda":
        y = selective_scan_cuda(u, dt_low, dt_w, A, B, C, D=D, z=z,
                                delta_bias=delta_bias,
                                delta_softplus=delta_softplus)
    elif impl == "ref":
        delta = torch.einsum("blr,rd->bld", dt_low.float(), dt_w.float())
        y = selective_scan_ref(u, delta, A, B, C, D=D, z=z,
                               delta_bias=delta_bias,
                               delta_softplus=delta_softplus)
    else:
        raise ValueError(f"unknown selective scan impl {impl!r}")
    return _flip(y) if reverse else y
