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
  * `selective_scan_fwd_train` / `selective_scan_bwd` : the training pair,
                             ports of the Pallas `_fwd_train_kernel` and
                             `_bwd_kernel` (`csrc/selective_scan_fwd_train.cu`,
                             `csrc/selective_scan_bwd.cu`); CPU tensors take
                             their plain versions (`..._ref`).
  * `SelectiveScanDtLowFn` : the autograd Function over that pair.
  * `selective_scan_dtlow` : the front end the mixer calls.  CPU tensors take
                             the plain version with ordinary autograd; CUDA
                             tensors take kernel 1 when no gradient is
                             needed and the Function when one is.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from dimsum_torch.ops import cuda_build
from dimsum_torch.ops.cuda_build import DTYPE_CODE, check_tensor, needs_grad

__all__ = ["selective_scan_ref", "selective_scan_cuda", "selective_scan_dtlow",
           "selective_scan_fwd_train", "selective_scan_fwd_train_ref",
           "selective_scan_fwd_train_states_ref",
           "selective_scan_fwd_train_cuda", "selective_scan_bwd",
           "selective_scan_bwd_ref", "selective_scan_bwd_core_ref",
           "selective_scan_bwd_core_cuda", "selective_scan_bwd_carry_ref",
           "SelectiveScanDtLowFn", "selective_scan_dtlow_train",
           "TRAIN_CHUNK"]

# Timesteps between the chunk-start states that the training forward saves
# and the backward replays from: the contract between kernels 2 and 3.  The
# backward runs the chunks in parallel, each lane keeping its states of one
# chunk in registers (csrc/selective_scan_bwd.cu).
TRAIN_CHUNK = 16
# The backward kernel's partial sums: dB and dC one per tile of
# _BWD_TILE channels, dA one per batch row and group of _BWD_GROUP chunks
# (kBlockCh and kGroup in csrc/selective_scan_bwd.cu).
_BWD_TILE, _BWD_GROUP = 64, 4


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
# CUDA kernels: one wrapper per source, each counting its launches
# ---------------------------------------------------------------------------

_MAX_STATE, _MAX_RANK = 32, 64


def _launch(name: str, dev, tensors, ints):
    """`dimsum_<name>` with the tensors' pointers (None for an absent one),
    then the int arguments."""
    cuda_build.launch(name, [ctypes.c_void_p] * len(tensors)
                      + [ctypes.c_int] * len(ints), dev, *tensors, *ints)


def _check_kernel_args(u, dt_low, dt_w, A, B, C, D, z, delta_bias):
    """The layout, types and sizes every selective-scan kernel takes:
    u, z (batch, L, dim); dt_low (batch, L, r); dt_w (r, dim); B, C
    (batch, L, N), all in u's dtype (float32 or bfloat16); A (dim, N),
    D and delta_bias (dim,) in float32; contiguous, on u's CUDA device."""
    if not u.is_cuda:
        raise ValueError("the CUDA selective scan takes CUDA tensors only")
    if B.ndim != 3 or C.ndim != 3:
        raise NotImplementedError(
            "grouped B/C is not implemented in the CUDA selective scan")
    if u.ndim != 3 or dt_low.ndim != 3 or dt_w.ndim != 2 or A.ndim != 2:
        raise ValueError("u, dt_low: (batch, L, ·); dt_w, A: 2-D")
    batch, L, dim = u.shape
    rank, n_state = dt_w.shape[0], A.shape[1]
    if u.dtype not in DTYPE_CODE:
        raise TypeError(f"unsupported dtype {u.dtype}: float32 or bfloat16")
    if not (1 <= n_state <= _MAX_STATE and 1 <= rank <= _MAX_RANK):
        raise NotImplementedError(
            f"CUDA selective scan takes 1 <= N <= {_MAX_STATE} and "
            f"1 <= dt_rank <= {_MAX_RANK}; got N={n_state}, r={rank}")
    dev, dt = u.device, u.dtype
    check_tensor("u", u, dev, dt, (batch, L, dim))
    check_tensor("dt_low", dt_low, dev, dt, (batch, L, rank))
    check_tensor("dt_w", dt_w, dev, dt, (rank, dim))
    check_tensor("A", A, dev, torch.float32, (dim, n_state))
    check_tensor("B", B, dev, dt, (batch, L, n_state))
    check_tensor("C", C, dev, dt, (batch, L, n_state))
    if D is not None:
        check_tensor("D", D, dev, torch.float32, (dim,))
    if z is not None:
        check_tensor("z", z, dev, dt, (batch, L, dim))
    if delta_bias is not None:
        check_tensor("delta_bias", delta_bias, dev, torch.float32, (dim,))


def selective_scan_cuda(u, dt_low, dt_w, A, B, C, D=None, z=None,
                        delta_bias=None, delta_softplus=False):
    """Launch the CUDA kernel: selective_scan(u, dt_low @ dt_w, ...) with
    the dt expansion, bias and softplus in fp32 inside the kernel.

    u, z: (batch, L, dim); dt_low: (batch, L, r); dt_w: (r, dim); B, C:
    (batch, L, N) -- all contiguous, on one CUDA device, in one dtype
    (float32 or bfloat16).  A: (dim, N), D and delta_bias: (dim,), float32.
    Raises on anything else; grouped B/C is not implemented here.  It has
    no backward: under grad mode with an input that requires grad it
    raises (the training route is `selective_scan_dtlow_train`)."""
    if needs_grad(u, dt_low, dt_w, A, B, C, D, z, delta_bias):
        raise RuntimeError(
            "selective_scan_cuda is the inference kernel and has no "
            "backward; take selective_scan_dtlow_train (kernels 2 and 3) "
            "or run under torch.no_grad()")
    if not u.is_cuda:
        raise ValueError("selective_scan_cuda takes CUDA tensors only")
    _check_kernel_args(u, dt_low, dt_w, A, B, C, D, z, delta_bias)
    batch, L, dim = u.shape
    rank, n_state = dt_w.shape[0], A.shape[1]
    dev, dt = u.device, u.dtype

    out = torch.empty_like(u)
    _launch("selective_scan_fwd", dev,
            (u, dt_low, dt_w, A, B, C, D, z, delta_bias, out),
            (batch, L, dim, n_state, rank, DTYPE_CODE[dt],
             int(bool(delta_softplus))))
    selective_scan_cuda.launches += 1
    return out


selective_scan_cuda.launches = 0


def _flip(v):
    return None if v is None else v.flip(1)


def _dt_expand(dt_low, dt_w, delta_bias, delta_softplus):
    """(dt, raw) in fp32: raw = dt_low @ dt_w (+ bias), dt = softplus(raw)
    or raw, the expansion the kernels make in fp32."""
    raw = torch.einsum("blr,rd->bld", dt_low.float(), dt_w.float())
    if delta_bias is not None:
        raw = raw + delta_bias.float()
    return (softplus(raw) if delta_softplus else raw), raw


# ---------------------------------------------------------------------------
# Training pair: forward with saved states (kernel 2) and backward (kernel 3)
# ---------------------------------------------------------------------------

def selective_scan_fwd_train_ref(u, dt_low, dt_w, A, B, C, D=None, z=None,
                                 delta_bias=None, delta_softplus=False,
                                 chunk: int = TRAIN_CHUNK, boundaries=None):
    """Plain version of kernel 2, the JAX `selective_scan_fwd_train`:
    returns (y, o, boundaries).  y is selective_scan's output in u's dtype;
    o = s + D*u is the fp32 pre-gate output (batch, L, dim); boundaries are
    the fp32 states at the start of each `chunk`-step chunk (the first one
    zero), (batch, ceil(L / chunk), N, dim).

    With `boundaries` (the state pass's, `selective_scan_fwd_train_states_
    ref`) every chunk starts from its own entry instead of the state the
    walk brings, as the kernel's main pass does; they are returned as
    given."""
    batch, L, dim = u.shape
    dt, _ = _dt_expand(dt_low, dt_w, delta_bias, delta_softplus)
    uf, Af, Bf, Cf = u.float(), A.float(), B.float(), C.float()
    du = dt * uf
    h = torch.zeros(batch, dim, A.shape[1], dtype=torch.float32,
                    device=u.device)
    ys, bnd = [], []
    for t in range(L):
        if t % chunk == 0:
            if boundaries is not None:
                h = boundaries[:, t // chunk].transpose(1, 2).float()
            bnd.append(h.transpose(1, 2))
        h = torch.exp(dt[:, t, :, None] * Af) * h \
            + du[:, t, :, None] * Bf[:, t, None, :]
        ys.append((h * Cf[:, t, None, :]).sum(-1))
    o = torch.stack(ys, dim=1)
    if D is not None:
        o = o + uf * D.float()
    y = o
    if z is not None:
        zf = z.float()
        y = o * (zf * torch.sigmoid(zf))
    return y.to(u.dtype), o, torch.stack(bnd, dim=1)


def selective_scan_fwd_train_states_ref(u, dt_low, dt_w, A, B,
                                        delta_bias=None,
                                        delta_softplus=False,
                                        chunk: int = TRAIN_CHUNK):
    """Plain version of kernel 2's state pass: the states at the start of
    every `chunk`-step chunk, (batch, ceil(L / chunk), N, dim) fp32, the
    boundaries of `selective_scan_fwd_train_ref`.  A chunk's effect on the
    state is affine, h_end = alpha h_start + beta, with alpha =
    exp(A sum_t dt_t) and beta its end state from a zero seed; they need
    only dt, u and B, so every chunk's come in parallel; then
    bnd_{c+1} = alpha_c bnd_c + beta_c from bnd_0 = 0.  A ragged last chunk
    runs with dt = 0 past the end, as the kernel does."""
    batch, L, dim = u.shape
    n = A.shape[1]
    nc = -(-L // chunk)
    pad = nc * chunk - L
    dt, _ = _dt_expand(dt_low, dt_w, delta_bias, delta_softplus)

    def chunks(x):  # (batch, L, k) -> (batch, nc, chunk, k), zero-padded
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, pad))
        return x.view(batch, nc, chunk, x.shape[-1])

    du, dt, Bf = chunks(dt * u.float()), chunks(dt), chunks(B)
    Af = A.float()
    beta = torch.zeros(batch, nc, dim, n, device=u.device)
    for t in range(chunk):
        beta = torch.exp(dt[:, :, t, :, None] * Af) * beta \
            + du[:, :, t, :, None] * Bf[:, :, t, None, :]
    alpha = torch.exp(dt.sum(2)[..., None] * Af)
    bnd = torch.empty(batch, nc, dim, n, device=u.device)
    h = torch.zeros(batch, dim, n, device=u.device)
    for c in range(nc):
        bnd[:, c] = h
        h = alpha[:, c] * h + beta[:, c]
    return bnd.transpose(2, 3).contiguous()


def selective_scan_bwd_carry_ref(dt_low, dt_w, A, C, delta_bias,
                                 delta_softplus, go,
                                 chunk: int = TRAIN_CHUNK):
    """Plain version of kernel 3's carry pass: w (batch, ceil(L / chunk), N,
    dim) fp32, the carry a_{t+1} e_{t+1} entering each chunk from the right
    at its last step t (zero for the last chunk).  The reverse recurrence
    e_t = C_t go_t + a_{t+1} e_{t+1} needs only dt, C and go, so every
    chunk's decay alpha = exp(A sum_t dt_t) and its carry out of its first
    step from a zero seed, beta, come in parallel; then
    w_{c-1} = alpha_c w_c + beta_c from the right.  A ragged last chunk runs
    with dt = 0 and go = 0 past the end, as the kernel does."""
    batch, L, _ = dt_low.shape
    dim, n = A.shape
    nc = -(-L // chunk)
    pad = nc * chunk - L
    dt, _ = _dt_expand(dt_low, dt_w, delta_bias, delta_softplus)

    def chunks(x):  # (batch, L, k) -> (batch, nc, chunk, k), zero-padded
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, pad))
        return x.view(batch, nc, chunk, x.shape[-1])

    dt, gof, Cf = chunks(dt), chunks(go), chunks(C)
    Af = A.float()
    beta = torch.zeros(batch, nc, dim, n, device=dt.device)
    for t in reversed(range(chunk)):
        beta = torch.exp(dt[:, :, t, :, None] * Af) * (
            gof[:, :, t, :, None] * Cf[:, :, t, None, :] + beta)
    alpha = torch.exp(dt.sum(2)[..., None] * Af)
    w = torch.empty(batch, nc, dim, n, device=dt.device)
    carry = torch.zeros(batch, dim, n, device=dt.device)
    for c in reversed(range(nc)):
        w[:, c] = carry
        carry = alpha[:, c] * carry + beta[:, c]
    return w.transpose(2, 3).contiguous()


def selective_scan_bwd_core_ref(u, dt_low, dt_w, A, B, C, delta_bias,
                                delta_softplus, go, boundaries,
                                chunk: int = TRAIN_CHUNK, carries=None,
                                return_carries: bool = False):
    """Plain version of kernel 3: the reverse recurrence of the JAX
    `selective_scan_bwd` docstring (selective_scan_bwd.py:27-36), chunk by
    chunk from the last, each chunk's states replayed from its saved start.
    go = dL/ds (fp32).  Returns fp32 (du_scan, ddelta, dA, dB, dC).

    The carry a_{t+1} e_{t+1} runs from chunk to chunk; with `carries`
    (the carry pass's w, `selective_scan_bwd_carry_ref`) each chunk starts
    from its own instead, as the kernel's chunks do.  `return_carries`
    appends the carries that entered the chunks, (batch, ceil(L / chunk),
    N, dim)."""
    batch, L, dim = u.shape
    n = A.shape[1]
    dt, raw = _dt_expand(dt_low, dt_w, delta_bias, delta_softplus)
    uf, Af, Bf, Cf = u.float(), A.float(), B.float(), C.float()
    du_s = torch.empty(batch, L, dim, device=u.device)
    ddt = torch.empty(batch, L, dim, device=u.device)
    dB = torch.empty(batch, L, n, device=u.device)
    dC = torch.empty(batch, L, n, device=u.device)
    dA = torch.zeros(dim, n, device=u.device)
    sig = torch.sigmoid(raw)
    carry = torch.zeros(batch, dim, n, device=u.device)  # a_{t+1} e_{t+1}
    seen = torch.empty(batch, boundaries.shape[1], dim, n, device=u.device)
    for c in reversed(range(boundaries.shape[1])):
        t0, t1 = c * chunk, min(L, (c + 1) * chunk)
        if carries is not None:
            carry = carries[:, c].transpose(1, 2).float()
        seen[:, c] = carry
        hs = [boundaries[:, c].transpose(1, 2).float()]
        for t in range(t0, t1):
            a = torch.exp(dt[:, t, :, None] * Af)
            hs.append(a * hs[-1] + (dt[:, t] * uf[:, t])[..., None]
                      * Bf[:, t, None, :])
        for t in reversed(range(t0, t1)):
            a = torch.exp(dt[:, t, :, None] * Af)
            e = go[:, t, :, None] * Cf[:, t, None, :] + carry
            da_a = e * hs[t - t0] * a
            eB = (e * Bf[:, t, None, :]).sum(-1)
            du_s[:, t] = eB * dt[:, t]
            ddt_p = eB * uf[:, t] + (da_a * Af).sum(-1)
            ddt[:, t] = ddt_p * sig[:, t] if delta_softplus else ddt_p
            dB[:, t] = (e * (dt[:, t] * uf[:, t])[..., None]).sum(1)
            dC[:, t] = (hs[t - t0 + 1] * go[:, t, :, None]).sum(1)
            dA += (da_a * dt[:, t, :, None]).sum(0)
            carry = a * e
    if return_carries:
        return du_s, ddt, dA, dB, dC, seen.transpose(2, 3).contiguous()
    return du_s, ddt, dA, dB, dC


def _bwd(core, u, dt_low, dt_w, A, B, C, D, z, delta_bias, delta_softplus,
         o, boundaries, g):
    """The JAX `selective_scan_bwd_pallas` around a reverse-scan core: the
    gate, D-skip and bias gradients in PyTorch, the dtype casts of
    selective_scan_bwd.py:277-280 (ddelta in the compute dtype of the
    delta = dt_low @ dt_w it is the gradient of)."""
    gf = g.float()
    if z is not None:
        zf = z.float()
        sig = torch.sigmoid(zf)
        go = gf * (zf * sig)
        dz = (gf * o * (sig * (1 + zf * (1 - sig)))).to(z.dtype)
    else:
        go, dz = gf, None
    go = go.contiguous()
    dD = (go * u.float()).sum((0, 1)) if D is not None else None
    du_s, ddt, dA, dB, dC = core(u, dt_low, dt_w, A, B, C, delta_bias,
                                 delta_softplus, go, boundaries)
    du = du_s + go * D.float() if D is not None else du_s
    dbias = ddt.sum((0, 1)) if delta_bias is not None else None
    return (du.to(u.dtype), ddt.to(dt_low.dtype), dA.to(A.dtype),
            dB.to(B.dtype), dC.to(C.dtype),
            None if dD is None else dD.to(D.dtype), dz,
            None if dbias is None else dbias.to(delta_bias.dtype))


def selective_scan_bwd_ref(u, dt_low, dt_w, A, B, C, D=None, z=None,
                           delta_bias=None, delta_softplus=False, *, o,
                           boundaries, g, chunk: int = TRAIN_CHUNK):
    """Plain version of the backward: given the forward's inputs, its o and
    boundaries, and g = dL/dy, returns (du, ddelta, dA, dB, dC, dD, dz,
    dbias), None for an absent optional; ddelta is dL/d(dt_low @ dt_w)."""
    return _bwd(functools.partial(selective_scan_bwd_core_ref, chunk=chunk),
                u, dt_low, dt_w, A, B, C, D, z, delta_bias, delta_softplus, o,
                boundaries, g)


def selective_scan_fwd_train_cuda(u, dt_low, dt_w, A, B, C, D=None, z=None,
                                  delta_bias=None, delta_softplus=False):
    """Launch kernel 2 (`csrc/selective_scan_fwd_train.cu`: its state
    pass, which writes the boundaries, then its main pass, the chunks in
    parallel from them), counted as one launch: kernel 1's y plus the fp32
    o and the states of `selective_scan_fwd_train_ref` at every
    TRAIN_CHUNK-th step (`selective_scan_fwd_train_states_ref`).  Takes
    what `selective_scan_cuda` takes; raises on anything else."""
    _check_kernel_args(u, dt_low, dt_w, A, B, C, D, z, delta_bias)
    batch, L, dim = u.shape
    rank, n_state = dt_w.shape[0], A.shape[1]
    y = torch.empty_like(u)
    o = torch.empty(batch, L, dim, device=u.device)
    bnd = torch.empty(batch, -(-L // TRAIN_CHUNK), n_state, dim,
                      device=u.device)
    _launch("selective_scan_fwd_train", u.device,
            (u, dt_low, dt_w, A, B, C, D, z, delta_bias, y, o, bnd),
            (batch, L, dim, n_state, rank, DTYPE_CODE[u.dtype],
             int(bool(delta_softplus))))
    selective_scan_fwd_train_cuda.launches += 1
    return y, o, bnd


selective_scan_fwd_train_cuda.launches = 0


def selective_scan_bwd_core_cuda(u, dt_low, dt_w, A, B, C, delta_bias,
                                 delta_softplus, go, boundaries):
    """Launch kernel 3 (`csrc/selective_scan_bwd.cu`: its carry pass, then
    its main pass), the CUDA counterpart of `selective_scan_bwd_core_ref`.
    The carry pass leaves the carry entering each chunk in a workspace
    (`selective_scan_bwd_carry_ref`'s w, in tiles of 8 channels).  dB/dC
    come back as one partial per tile of _BWD_TILE channels and dA as one
    per batch row and group of _BWD_GROUP chunks; the sums here make them
    deterministic (no float atomics)."""
    _check_kernel_args(u, dt_low, dt_w, A, B, C, None, None, delta_bias)
    batch, L, dim = u.shape
    rank, n_state = dt_w.shape[0], A.shape[1]
    n_chunks = -(-L // TRAIN_CHUNK)
    check_tensor("go", go, u.device, torch.float32, (batch, L, dim))
    check_tensor("boundaries", boundaries, u.device, torch.float32,
                 (batch, n_chunks, n_state, dim))
    dev = u.device
    parts, groups = -(-dim // _BWD_TILE), -(-n_chunks // _BWD_GROUP)
    # the carry pass's w, in tiles of 8 channels: (batch, n_chunks,
    # ceil(dim / 8), N, 8)
    w = torch.empty(batch, n_chunks, -(-dim // 8) * n_state * 8, device=dev)
    du_s = torch.empty(batch, L, dim, device=dev)
    ddt = torch.empty(batch, L, dim, device=dev)
    dB_p = torch.empty(parts, batch, L, n_state, device=dev)
    dC_p = torch.empty(parts, batch, L, n_state, device=dev)
    dA_p = torch.empty(batch, groups, dim, n_state, device=dev)
    _launch("selective_scan_bwd", dev,
            (u, dt_low, dt_w, A, B, C, delta_bias, go, boundaries, w, du_s,
             ddt, dB_p, dC_p, dA_p),
            (batch, L, dim, n_state, rank, DTYPE_CODE[u.dtype],
             int(bool(delta_softplus))))
    selective_scan_bwd_core_cuda.launches += 1
    return du_s, ddt, dA_p.sum((0, 1)), dB_p.sum(0), dC_p.sum(0)


selective_scan_bwd_core_cuda.launches = 0


def selective_scan_fwd_train(u, dt_low, dt_w, A, B, C, D=None, z=None,
                             delta_bias=None, delta_softplus=False):
    """Kernel 2 for CUDA tensors, its plain version for CPU tensors."""
    fn = selective_scan_fwd_train_cuda if u.is_cuda else \
        selective_scan_fwd_train_ref
    return fn(u, dt_low, dt_w, A, B, C, D, z, delta_bias, delta_softplus)


def selective_scan_bwd(u, dt_low, dt_w, A, B, C, D=None, z=None,
                       delta_bias=None, delta_softplus=False, *, o,
                       boundaries, g):
    """`selective_scan_bwd_ref` with its reverse scan on kernel 3 for CUDA
    tensors (on the plain version for CPU tensors)."""
    core = selective_scan_bwd_core_cuda if u.is_cuda else \
        selective_scan_bwd_core_ref
    return _bwd(core, u, dt_low, dt_w, A, B, C, D, z, delta_bias,
                delta_softplus, o, boundaries, g)


class SelectiveScanDtLowFn(torch.autograd.Function):
    """selective_scan(u, dt_low @ dt_w, ...) with the JAX package's training
    rules (`_dtlow_fwd`/`_dtlow_bwd`, selective_scan.py:812-835): the
    forward saves o and the chunk-start states, the backward replays them;
    ddelta goes back through the expansion as two fp32 products,
    ddt_low = ddelta @ dt_w^T and ddt_w = dt_low^T @ ddelta."""

    @staticmethod
    def forward(ctx, u, dt_low, dt_w, A, B, C, D, z, delta_bias,
                delta_softplus):
        y, o, bnd = selective_scan_fwd_train(
            u, dt_low, dt_w, A, B, C, D, z, delta_bias, delta_softplus)
        ctx.delta_softplus = delta_softplus
        ctx.save_for_backward(u, dt_low, dt_w, A, B, C, D, z, delta_bias,
                              o, bnd)
        return y

    @staticmethod
    def backward(ctx, g):
        u, dt_low, dt_w, A, B, C, D, z, delta_bias, o, bnd = \
            ctx.saved_tensors
        du, ddelta, dA, dB, dC, dD, dz, dbias = selective_scan_bwd(
            u, dt_low, dt_w, A, B, C, D, z, delta_bias, ctx.delta_softplus,
            o=o, boundaries=bnd, g=g.contiguous())
        dd = ddelta.float()
        ddt_low = torch.matmul(dd, dt_w.float().t()).to(dt_low.dtype)
        ddt_w = torch.einsum("blr,bld->rd", dt_low.float(), dd).to(
            dt_w.dtype)
        return du, ddt_low, ddt_w, dA, dB, dC, dD, dz, dbias, None


def selective_scan_dtlow_train(u, dt_low, dt_w, A, B, C, D=None, z=None,
                               delta_bias=None, delta_softplus=False,
                               reverse: bool = False):
    """`SelectiveScanDtLowFn`, with `reverse` as flips around it (autograd
    differentiates the flips), as `_dtlow_fwd`/`_dtlow_bwd` do.  Kernels 2
    and 3 for CUDA tensors, their plain versions for CPU tensors."""
    if reverse:
        u, dt_low, B, C, z = (_flip(u), _flip(dt_low), _flip(B), _flip(C),
                              _flip(z))
    y = SelectiveScanDtLowFn.apply(u, dt_low, dt_w, A, B, C, D, z,
                                   delta_bias, delta_softplus)
    return _flip(y) if reverse else y


def selective_scan_dtlow(u, dt_low, dt_w, A, B, C, D=None, z=None,
                         delta_bias=None, delta_softplus=False,
                         reverse: bool = False, impl: Optional[str] = None):
    """selective_scan(u, dt_low @ dt_w, ...), the JAX `selective_scan_dtlow`.

    `dt_low` (batch, L, r) is the dt_proj input and `dt_w` (r, dim) its
    weight; the expansion is computed in fp32 (as the Pallas kernel does on
    its MXU).  `reverse=True` computes flip_L(scan(flip_L(inputs))).

    `impl`: None takes the CUDA kernels for CUDA tensors and the plain
    version for CPU tensors; "ref" takes the plain version on any device,
    differentiated by autograd; "cuda" takes the kernels and raises for CPU
    tensors.  On the kernel route, kernel 1 runs when no input needs a
    gradient (no_grad, inference_mode, or frozen inputs) and
    `selective_scan_dtlow_train` (kernels 2 and 3) when one does.  There is
    no fallback: a shape or dtype the kernels do not take raises."""
    if impl is None:
        impl = "cuda" if u.is_cuda else "ref"
    if impl == "cuda":
        if not u.is_cuda:
            raise ValueError("impl='cuda' takes CUDA tensors only")
        if needs_grad(u, dt_low, dt_w, A, B, C, D, z, delta_bias):
            return selective_scan_dtlow_train(
                u, dt_low, dt_w, A, B, C, D=D, z=z, delta_bias=delta_bias,
                delta_softplus=delta_softplus, reverse=reverse)
    elif impl != "ref":
        raise ValueError(f"unknown selective scan impl {impl!r}")
    if reverse:
        u, dt_low, B, C, z = (_flip(u), _flip(dt_low), _flip(B), _flip(C),
                              _flip(z))
    if impl == "cuda":
        y = selective_scan_cuda(u, dt_low, dt_w, A, B, C, D=D, z=z,
                                delta_bias=delta_bias,
                                delta_softplus=delta_softplus)
    else:
        delta = torch.einsum("blr,rd->bld", dt_low.float(), dt_w.float())
        y = selective_scan_ref(u, delta, A, B, C, D=D, z=z,
                               delta_bias=delta_bias,
                               delta_softplus=delta_softplus)
    return _flip(y) if reverse else y
