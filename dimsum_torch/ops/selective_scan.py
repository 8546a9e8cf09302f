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
                             expanded in the kernel; `reverse=True` takes
                             the source's reverse entry (`_scan_body`'s
                             reverse-time case), with no flip.
  * `selective_scan_state` : a full delta, the state seeded from h0 and the
                             last state returned (the JAX
                             `_selective_scan_pallas_fwd_impl` with dt_w
                             None, h0 and want_last_state), the local passes
                             of the sequence-parallel scan.  CUDA tensors
                             take `selective_scan_state_cuda` (the same
                             source's second entry, the port of
                             `_scan_kernel_with_state`), CPU tensors the
                             plain version.
  * `selective_scan_fwd_train` / `selective_scan_bwd` : the training pair,
                             ports of the Pallas `_fwd_train_kernel` and
                             `_bwd_kernel` (`csrc/selective_scan_fwd_train.cu`,
                             `csrc/selective_scan_bwd.cu`); CPU tensors take
                             their plain versions (`..._ref`).
  * `SelectiveScanDtLowFn` : the autograd Function over that pair; an
                             optional h0 (the `use_cond_init` seed) goes
                             to both kernels' h0 entries, and dh0 comes
                             back.
  * `selective_scan`       : the JAX front end, a full delta: CUDA tensors
                             take the state entry without a gradient,
                             `SelectiveScanFn` (kernels 2 and 3 on a full
                             delta) with one, `SelectiveScanGroupedFn`
                             (the state entry, its backward through the
                             plain scan) for grouped B/C with one.
  * `selective_state_update` : one decode step of the recurrence, plain
                             PyTorch (plain jnp in JAX).

The kernels take N up to 256 (the reference kernel's largest), grouped B/C
in kernel 1's and the state entry's split instantiations.
  * `selective_scan_dtlow` : the front end the mixer calls.  CPU tensors take
                             the plain version with ordinary autograd; CUDA
                             tensors take kernel 1 (its reverse entry for
                             `reverse=True`) when no gradient is needed and
                             the Function, between flips for `reverse`, when
                             one is; with h0 the state entry and the
                             Function with h0.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from dimsum_torch.ops import cuda_build
from dimsum_torch.ops.cuda_build import DTYPE_CODE, check_tensor, needs_grad
from dimsum_torch.utils import remat

__all__ = ["selective_scan", "selective_scan_ref", "selective_scan_cuda",
           "selective_scan_dtlow", "SelectiveScanFn", "SelectiveScanGroupedFn",
           "selective_scan_state", "selective_scan_state_cuda",
           "selective_scan_fwd_train", "selective_scan_fwd_train_ref",
           "selective_scan_fwd_train_states_ref",
           "selective_scan_fwd_train_cuda", "selective_scan_bwd",
           "selective_scan_bwd_ref", "selective_scan_bwd_core_ref",
           "selective_scan_bwd_core_cuda", "selective_scan_bwd_carry_ref",
           "SelectiveScanDtLowFn", "selective_scan_dtlow_train",
           "selective_state_update", "TRAIN_CHUNK"]

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
                       delta_softplus=False, return_last_state=False,
                       h0=None):
    """Sequential fp32 recurrence (mirrors the JAX `selective_scan_ref`).
    The output is in u's dtype; the last state is (batch, dim, N) fp32.
    `h0` (batch, dim, N) seeds the state (zero without it), as in the JAX
    `selective_scan_xla`."""
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
    h = (torch.zeros(batch, dim, A.shape[1], dtype=torch.float32,
                     device=u.device) if h0 is None else h0.float())
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

# The kernels' largest N and dt_rank: N 256 is the reference CUDA kernel's
# largest (selective_scan.cpp:262), RMAX 256 their largest template (d_model
# 4096 at dt_rank = ceil(d_model / 16)); the Pallas kernel takes any rank,
# and a rank or N above these raises.  Up to _TILE states run on the
# sources' first instantiations; more, and grouped B/C, on their split ones
# (kSplit: tiles of _TILE states, a workspace of fp32 partial sums).
_MAX_STATE, _MAX_RANK, _TILE = 256, 256, 32


def _tiles(n_state: int) -> int:
    """The split instantiations' state tiles: one up to _TILE states."""
    return -(-n_state // _TILE)


def _workspace(n_state: int, shape, device):
    """The split instantiations' partial sums, (tiles, *shape) fp32, or
    None at one tile (the kernel then stores its outputs itself)."""
    tiles = _tiles(n_state)
    return (torch.empty(tiles, *shape, device=device) if tiles > 1
            else None)


def _launch(name: str, dev, tensors, ints, entry: Optional[str] = None):
    """`dimsum_<name>` (or its `entry`) with the tensors' pointers (None
    for an absent one), then the int arguments."""
    cuda_build.launch(name, [ctypes.c_void_p] * len(tensors)
                      + [ctypes.c_int] * len(ints), dev, *tensors, *ints,
                      entry=entry)


def _check_common_args(u, A, B, C, D, z, delta_bias):
    """What every selective-scan kernel takes besides dt: u, z
    (batch, L, dim); B, C (batch, L, N) or grouped (batch, L, G, N), G
    dividing dim, all in u's dtype (float32 or bfloat16); A (dim, N), D and
    delta_bias (dim,) in float32; contiguous, on u's CUDA device;
    1 <= N <= 256.  Returns G (1 for a 3-D B)."""
    if not u.is_cuda:
        raise ValueError("the CUDA selective scan takes CUDA tensors only")
    if u.ndim != 3 or A.ndim != 2 or B.ndim not in (3, 4) \
            or C.ndim != B.ndim:
        raise ValueError("u: (batch, L, dim); A: (dim, N); B, C: "
                         "(batch, L, N) or (batch, L, G, N)")
    batch, L, dim = u.shape
    n_state = A.shape[1]
    if u.dtype not in DTYPE_CODE:
        raise TypeError(f"unsupported dtype {u.dtype}: float32 or bfloat16")
    if not 1 <= n_state <= _MAX_STATE:
        raise NotImplementedError(
            f"CUDA selective scan takes 1 <= N <= {_MAX_STATE}; "
            f"got N={n_state}")
    groups = B.shape[2] if B.ndim == 4 else 1
    if groups < 1 or dim % groups:
        raise ValueError(f"{groups} groups of B/C do not divide dim {dim}")
    bc = (batch, L, groups, n_state) if B.ndim == 4 else (batch, L, n_state)
    dev, dt = u.device, u.dtype
    check_tensor("u", u, dev, dt, (batch, L, dim))
    check_tensor("A", A, dev, torch.float32, (dim, n_state))
    check_tensor("B", B, dev, dt, bc)
    check_tensor("C", C, dev, dt, bc)
    if D is not None:
        check_tensor("D", D, dev, torch.float32, (dim,))
    if z is not None:
        check_tensor("z", z, dev, dt, (batch, L, dim))
    if delta_bias is not None:
        check_tensor("delta_bias", delta_bias, dev, torch.float32, (dim,))
    return groups


def _check_kernel_args(u, dt_low, dt_w, A, B, C, D, z, delta_bias):
    """The layout, types and sizes the dt_low route's kernels take: those
    of `_check_common_args`, and dt_low (batch, L, r), dt_w (r, dim) in
    u's dtype, 1 <= r <= 256 (`_MAX_RANK`; above it NotImplementedError).
    dt_w None: dt_low is a full delta (batch, L, dim) in u's dtype.
    Returns G."""
    groups = _check_common_args(u, A, B, C, D, z, delta_bias)
    if dt_w is None:
        check_tensor("delta", dt_low, u.device, u.dtype, u.shape)
        return groups
    if dt_low.ndim != 3 or dt_w.ndim != 2:
        raise ValueError("dt_low: (batch, L, r); dt_w: (r, dim)")
    batch, L, dim = u.shape
    rank = dt_w.shape[0]
    if not 1 <= rank <= _MAX_RANK:
        raise NotImplementedError(
            f"CUDA selective scan takes 1 <= dt_rank <= {_MAX_RANK}; "
            f"got r={rank}")
    check_tensor("dt_low", dt_low, u.device, u.dtype, (batch, L, rank))
    check_tensor("dt_w", dt_w, u.device, u.dtype, (rank, dim))
    return groups


def _check_state_args(u, delta, A, B, C, D, z, delta_bias, h0):
    """The layout, types and sizes the state entry takes: those of
    `_check_common_args`, a full delta (batch, L, dim) in u's dtype and,
    where given, h0 (batch, dim, N) in float32.  Returns G."""
    groups = _check_common_args(u, A, B, C, D, z, delta_bias)
    batch, L, dim = u.shape
    check_tensor("delta", delta, u.device, u.dtype, (batch, L, dim))
    if h0 is not None:
        check_tensor("h0", h0, u.device, torch.float32,
                     (batch, dim, A.shape[1]))
    return groups


def _check_train_args(u, dt_low, dt_w, A, B, C, D, z, delta_bias):
    """`_check_kernel_args` for the training pair, which takes one B/C a
    step: grouped B/C raises (selective_scan's grouped route runs its
    backward through the plain scan, as the JAX `_grouped_bwd`)."""
    if B.ndim == 4:
        raise NotImplementedError(
            "grouped B/C: the training kernels take B, C (batch, L, N); "
            "selective_scan's grouped route recomputes the backward")
    _check_kernel_args(u, dt_low, dt_w, A, B, C, D, z, delta_bias)


def selective_scan_cuda(u, dt_low, dt_w, A, B, C, D=None, z=None,
                        delta_bias=None, delta_softplus=False,
                        reverse: bool = False):
    """Launch the CUDA kernel: selective_scan(u, dt_low @ dt_w, ...) with
    the dt expansion, bias and softplus in fp32 inside the kernel.  With
    `reverse` the reverse entry runs the recurrence from the last step to
    the first: flip_L(selective_scan(flip_L(u, dt_low, B, C, z))), with no
    flip made.  `launches` counts every launch, `reverse_launches` those of
    the reverse entry.

    u, z: (batch, L, dim); dt_low: (batch, L, r); dt_w: (r, dim); B, C:
    (batch, L, N) -- all contiguous, on one CUDA device, in one dtype
    (float32 or bfloat16).  A: (dim, N), D and delta_bias: (dim,), float32.
    B, C may be grouped, (batch, L, G, N).  Above 32 states, or grouped,
    the source's split entry runs (`split_launches` counts those).  Raises
    on anything else.  It has no backward: under grad mode with an input
    that requires grad it raises (the training route is
    `selective_scan_dtlow_train`)."""
    if needs_grad(u, dt_low, dt_w, A, B, C, D, z, delta_bias):
        raise RuntimeError(
            "selective_scan_cuda is the inference kernel and has no "
            "backward; take selective_scan_dtlow_train (kernels 2 and 3) "
            "or run under torch.no_grad()")
    if not u.is_cuda:
        raise ValueError("selective_scan_cuda takes CUDA tensors only")
    groups = _check_kernel_args(u, dt_low, dt_w, A, B, C, D, z, delta_bias)
    batch, L, dim = u.shape
    rank, n_state = dt_w.shape[0], A.shape[1]
    dev, dt = u.device, u.dtype

    out = torch.empty_like(u)
    flags = (DTYPE_CODE[dt], int(bool(delta_softplus)))
    split = B.ndim == 4 or n_state > _TILE
    if split:
        _launch("selective_scan_fwd", dev,
                (u, dt_low, dt_w, A, B, C, D, z, delta_bias, out,
                 _workspace(n_state, u.shape, dev)),
                (batch, L, dim, n_state, rank, groups, *flags, int(reverse)),
                entry="split")
    else:
        _launch("selective_scan_fwd", dev,
                (u, dt_low, dt_w, A, B, C, D, z, delta_bias, out),
                (batch, L, dim, n_state, rank, *flags),
                entry="reverse" if reverse else None)
    selective_scan_cuda.launches += 1
    selective_scan_cuda.reverse_launches += bool(reverse)
    selective_scan_cuda.split_launches += split
    return out


selective_scan_cuda.launches = 0
selective_scan_cuda.reverse_launches = 0
selective_scan_cuda.split_launches = 0


def selective_scan_state_cuda(u, delta, A, B, C, D=None, z=None,
                              delta_bias=None, delta_softplus=False, h0=None,
                              return_last_state=False):
    """Launch the state entry of `csrc/selective_scan_fwd.cu`:
    selective_scan(u, delta, ...) with a full delta (batch, L, dim) in u's
    dtype (the bias and softplus in fp32 inside the kernel), the state
    seeded from `h0` (batch, dim, N) fp32 (zero without it), and with
    `return_last_state` also the state after the last step, (batch, dim, N)
    fp32.  The other arguments as `selective_scan_cuda`; grouped B/C
    (batch, L, G, N) is `_scan_kernel_with_state`'s grouped case, with h0
    and the last state as without groups.  Above 32 states, or grouped,
    the source's split state entry runs (`split_launches` counts those,
    `grouped_launches` the grouped ones).  Raises on anything else, and
    under grad mode with an input that requires grad (it has no
    backward)."""
    if needs_grad(u, delta, A, B, C, D, z, delta_bias, h0):
        raise RuntimeError(
            "selective_scan_state_cuda is an inference kernel and has no "
            "backward; run it under torch.no_grad()")
    groups = _check_state_args(u, delta, A, B, C, D, z, delta_bias, h0)
    batch, L, dim = u.shape
    n_state = A.shape[1]
    out = torch.empty_like(u)
    last = (torch.empty(batch, dim, n_state, device=u.device)
            if return_last_state else None)
    flags = (DTYPE_CODE[u.dtype], int(bool(delta_softplus)))
    split = B.ndim == 4 or n_state > _TILE
    if split:
        _launch("selective_scan_fwd", u.device,
                (u, delta, A, B, C, D, z, delta_bias, h0, out, last,
                 _workspace(n_state, u.shape, u.device)),
                (batch, L, dim, n_state, groups, *flags),
                entry="state_split")
    else:
        _launch("selective_scan_fwd", u.device,
                (u, delta, A, B, C, D, z, delta_bias, h0, out, last),
                (batch, L, dim, n_state, *flags), entry="state")
    selective_scan_state_cuda.launches += 1
    selective_scan_state_cuda.split_launches += split
    selective_scan_state_cuda.grouped_launches += B.ndim == 4
    return (out, last) if return_last_state else out


selective_scan_state_cuda.launches = 0
selective_scan_state_cuda.split_launches = 0
selective_scan_state_cuda.grouped_launches = 0


def selective_scan_state(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                         delta_softplus=False, h0=None,
                         return_last_state=False, impl: Optional[str] = None):
    """selective_scan(u, delta, ...) with a full delta, seeded from `h0`
    and with `return_last_state` also returning the last state: the JAX
    `_selective_scan_pallas_fwd_impl(..., h0=h0,
    want_last_state=return_last_state)` with dt_w None.

    `impl`: None takes `selective_scan_state_cuda` for CUDA tensors and
    `selective_scan_ref` for CPU tensors; "ref" the plain version on any
    device; "cuda" the kernel, which raises for CPU tensors."""
    if impl is None:
        impl = "cuda" if u.is_cuda else "ref"
    if impl == "cuda":
        if not u.is_cuda:
            raise ValueError("impl='cuda' takes CUDA tensors only")
        fn = selective_scan_state_cuda
    elif impl == "ref":
        fn = selective_scan_ref
    else:
        raise ValueError(f"unknown selective scan impl {impl!r}")
    return fn(u, delta, A, B, C, D, z, delta_bias, delta_softplus, h0=h0,
              return_last_state=return_last_state)


def _flip(v):
    return None if v is None else v.flip(1)


def _dt_expand(dt_low, dt_w, delta_bias, delta_softplus):
    """(dt, raw) in fp32: raw = dt_low @ dt_w (+ bias), dt = softplus(raw)
    or raw, the expansion the kernels make in fp32.  dt_w None: dt_low is
    the full delta (batch, L, dim), raw = delta (+ bias)."""
    raw = (dt_low.float() if dt_w is None else
           torch.einsum("blr,rd->bld", dt_low.float(), dt_w.float()))
    if delta_bias is not None:
        raw = raw + delta_bias.float()
    return (softplus(raw) if delta_softplus else raw), raw


# ---------------------------------------------------------------------------
# Training pair: forward with saved states (kernel 2) and backward (kernel 3)
# ---------------------------------------------------------------------------

def selective_scan_fwd_train_ref(u, dt_low, dt_w, A, B, C, D=None, z=None,
                                 delta_bias=None, delta_softplus=False,
                                 chunk: int = TRAIN_CHUNK, boundaries=None,
                                 h0=None):
    """Plain version of kernel 2, the JAX `selective_scan_fwd_train`
    (dt_w None: dt_low is a full delta, as there): returns (y, o,
    boundaries).  y is selective_scan's output in u's dtype;
    o = s + D*u is the fp32 pre-gate output (batch, L, dim); boundaries are
    the fp32 states at the start of each `chunk`-step chunk (the first one
    zero, or `h0` (batch, dim, N) when given: the state before step 0, as
    in the JAX `selective_scan_xla(..., h0=h0)`), (batch, ceil(L / chunk),
    N, dim).

    With `boundaries` (the state pass's, `selective_scan_fwd_train_states_
    ref`) every chunk starts from its own entry instead of the state the
    walk brings, as the kernel's main pass does; they are returned as
    given."""
    batch, L, dim = u.shape
    dt, _ = _dt_expand(dt_low, dt_w, delta_bias, delta_softplus)
    uf, Af, Bf, Cf = u.float(), A.float(), B.float(), C.float()
    du = dt * uf
    h = (torch.zeros(batch, dim, A.shape[1], dtype=torch.float32,
                     device=u.device) if h0 is None else h0.float())
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
                                        chunk: int = TRAIN_CHUNK, h0=None):
    """Plain version of kernel 2's state pass: the states at the start of
    every `chunk`-step chunk, (batch, ceil(L / chunk), N, dim) fp32, the
    boundaries of `selective_scan_fwd_train_ref`.  A chunk's effect on the
    state is affine, h_end = alpha h_start + beta, with alpha =
    exp(A sum_t dt_t) and beta its end state from a zero seed; they need
    only dt, u and B, so every chunk's come in parallel; then
    bnd_{c+1} = alpha_c bnd_c + beta_c from bnd_0 = 0 (or `h0`, (batch,
    dim, N)).  A ragged last chunk runs with dt = 0 past the end, as the
    kernel does."""
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
    h = (torch.zeros(batch, dim, n, device=u.device) if h0 is None
         else h0.float())
    for c in range(nc):
        bnd[:, c] = h
        h = alpha[:, c] * h + beta[:, c]
    return bnd.transpose(2, 3).contiguous()


def selective_scan_bwd_carry_ref(dt_low, dt_w, A, C, delta_bias,
                                 delta_softplus, go,
                                 chunk: int = TRAIN_CHUNK,
                                 return_dh0: bool = False):
    """Plain version of kernel 3's carry pass: w (batch, ceil(L / chunk), N,
    dim) fp32, the carry a_{t+1} e_{t+1} entering each chunk from the right
    at its last step t (zero for the last chunk).  The reverse recurrence
    e_t = C_t go_t + a_{t+1} e_{t+1} needs only dt, C and go, so every
    chunk's decay alpha = exp(A sum_t dt_t) and its carry out of its first
    step from a zero seed, beta, come in parallel; then
    w_{c-1} = alpha_c w_c + beta_c from the right.  A ragged last chunk runs
    with dt = 0 and go = 0 past the end, as the kernel does.  The chain's
    one step more, alpha_0 w_0 + beta_0 = a_0 e_0, is the gradient of an
    h0 seed (the state before step 0), (batch, dim, N): with `return_dh0`
    it is returned beside w."""
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
    w = w.transpose(2, 3).contiguous()
    return (w, carry) if return_dh0 else w


def selective_scan_bwd_core_ref(u, dt_low, dt_w, A, B, C, delta_bias,
                                delta_softplus, go, boundaries,
                                chunk: int = TRAIN_CHUNK, carries=None,
                                return_carries: bool = False,
                                return_dh0: bool = False):
    """Plain version of kernel 3: the reverse recurrence of the JAX
    `selective_scan_bwd` docstring (selective_scan_bwd.py:27-36), chunk by
    chunk from the last, each chunk's states replayed from its saved start.
    go = dL/ds (fp32).  Returns fp32 (du_scan, ddelta, dA, dB, dC).

    The carry a_{t+1} e_{t+1} runs from chunk to chunk; with `carries`
    (the carry pass's w, `selective_scan_bwd_carry_ref`) each chunk starts
    from its own instead, as the kernel's chunks do.  `return_dh0` appends
    the carry out of step 0, a_0 e_0, the gradient of an h0 seed (batch,
    dim, N); `return_carries` then appends the carries that entered the
    chunks, (batch, ceil(L / chunk), N, dim)."""
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
    out = (du_s, ddt, dA, dB, dC) + ((carry,) if return_dh0 else ())
    if return_carries:
        return out + (seen.transpose(2, 3).contiguous(),)
    return out


def _bwd(core, u, dt_low, dt_w, A, B, C, D, z, delta_bias, delta_softplus,
         o, boundaries, g, h0=None):
    """The JAX `selective_scan_bwd_pallas` around a reverse-scan core: the
    gate, D-skip and bias gradients in PyTorch, the dtype casts of
    selective_scan_bwd.py:277-280 (ddelta in the compute dtype of the
    delta = dt_low @ dt_w it is the gradient of).  With `h0` the core also
    gives dh0, appended in h0's dtype (fp32)."""
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
    parts = core(u, dt_low, dt_w, A, B, C, delta_bias, delta_softplus, go,
                 boundaries, **({} if h0 is None else {"return_dh0": True}))
    du_s, ddt, dA, dB, dC = parts[:5]
    du = du_s + go * D.float() if D is not None else du_s
    dbias = ddt.sum((0, 1)) if delta_bias is not None else None
    out = (du.to(u.dtype), ddt.to(dt_low.dtype), dA.to(A.dtype),
           dB.to(B.dtype), dC.to(C.dtype),
           None if dD is None else dD.to(D.dtype), dz,
           None if dbias is None else dbias.to(delta_bias.dtype))
    return out if h0 is None else out + (parts[5].to(h0.dtype),)


def selective_scan_bwd_ref(u, dt_low, dt_w, A, B, C, D=None, z=None,
                           delta_bias=None, delta_softplus=False, *, o,
                           boundaries, g, chunk: int = TRAIN_CHUNK, h0=None):
    """Plain version of the backward: given the forward's inputs, its o and
    boundaries, and g = dL/dy, returns (du, ddelta, dA, dB, dC, dD, dz,
    dbias), None for an absent optional; ddelta is dL/d(dt_low @ dt_w).
    With `h0` (the forward's seed) dh0 (batch, dim, N) fp32 follows."""
    return _bwd(functools.partial(selective_scan_bwd_core_ref, chunk=chunk),
                u, dt_low, dt_w, A, B, C, D, z, delta_bias, delta_softplus, o,
                boundaries, g, h0=h0)


def selective_scan_fwd_train_cuda(u, dt_low, dt_w, A, B, C, D=None, z=None,
                                  delta_bias=None, delta_softplus=False,
                                  h0=None):
    """Launch kernel 2 (`csrc/selective_scan_fwd_train.cu`: its state
    pass, which writes the boundaries, then its main pass, the chunks in
    parallel from them), counted as one launch: kernel 1's y plus the fp32
    o and the states of `selective_scan_fwd_train_ref` at every
    TRAIN_CHUNK-th step (`selective_scan_fwd_train_states_ref`).  Takes
    what `selective_scan_cuda` takes but grouped B/C, and `h0` (batch,
    dim, N) float32, the state before step 0 (the source's h0 entry;
    `h0_launches` counts those); raises on anything else.  Above 32 states
    the split entry runs (`split_launches`).  dt_w None: dt_low is a full
    delta (batch, L, dim) in u's dtype, the JAX `_pallas_fwd`'s input (the
    source's delta entry, `delta_launches`; no h0)."""
    _check_train_args(u, dt_low, dt_w, A, B, C, D, z, delta_bias)
    batch, L, dim = u.shape
    n_state = A.shape[1]
    if h0 is not None:
        if dt_w is None:
            raise NotImplementedError("the full-delta entry takes no h0")
        check_tensor("h0", h0, u.device, torch.float32, (batch, dim, n_state))
    y = torch.empty_like(u)
    o = torch.empty(batch, L, dim, device=u.device)
    bnd = torch.empty(batch, -(-L // TRAIN_CHUNK), n_state, dim,
                      device=u.device)
    flags = (DTYPE_CODE[u.dtype], int(bool(delta_softplus)))
    outs = (y, o, bnd)
    counts = selective_scan_fwd_train_cuda
    if dt_w is None:
        _launch("selective_scan_fwd_train", u.device,
                (u, dt_low, A, B, C, D, z, delta_bias, *outs,
                 _workspace(n_state, u.shape, u.device)),
                (batch, L, dim, n_state, *flags), entry="delta")
        counts.delta_launches += 1
    elif n_state > _TILE:
        _launch("selective_scan_fwd_train", u.device,
                (u, dt_low, dt_w, A, B, C, D, z, delta_bias, *outs, h0,
                 _workspace(n_state, u.shape, u.device)),
                (batch, L, dim, n_state, dt_w.shape[0], *flags),
                entry="split")
        counts.split_launches += 1
    else:
        seed = () if h0 is None else (h0,)
        _launch("selective_scan_fwd_train", u.device,
                (u, dt_low, dt_w, A, B, C, D, z, delta_bias, *outs, *seed),
                (batch, L, dim, n_state, dt_w.shape[0], *flags),
                entry="h0" if seed else None)
    counts.launches += 1
    counts.h0_launches += h0 is not None
    return outs


selective_scan_fwd_train_cuda.launches = 0
selective_scan_fwd_train_cuda.h0_launches = 0
selective_scan_fwd_train_cuda.split_launches = 0
selective_scan_fwd_train_cuda.delta_launches = 0


def selective_scan_bwd_core_cuda(u, dt_low, dt_w, A, B, C, delta_bias,
                                 delta_softplus, go, boundaries,
                                 return_dh0: bool = False):
    """Launch kernel 3 (`csrc/selective_scan_bwd.cu`: its carry pass, then
    its main pass), the CUDA counterpart of `selective_scan_bwd_core_ref`.
    The carry pass leaves the carry entering each chunk in a workspace
    (`selective_scan_bwd_carry_ref`'s w, in tiles of 8 channels).  dB/dC
    come back as one partial per tile of _BWD_TILE channels and dA as one
    per batch row and group of _BWD_GROUP chunks; the sums here make them
    deterministic (no float atomics).  `return_dh0` takes the source's h0
    entry, whose carry pass also writes dh0 (batch, dim, N) fp32, appended
    (`h0_launches` counts those).  Above 32 states the split entry runs
    (`split_launches`): du and ddt come back one slice a tile of 32 states,
    summed here.  dt_w None: dt_low is a full delta (batch, L, dim), the
    JAX `_pallas_bwd`'s input (the delta entry, `delta_launches`; no
    dh0)."""
    _check_train_args(u, dt_low, dt_w, A, B, C, None, None, delta_bias)
    batch, L, dim = u.shape
    n_state = A.shape[1]
    if return_dh0 and dt_w is None:
        raise NotImplementedError("the full-delta entry takes no h0")
    n_chunks = -(-L // TRAIN_CHUNK)
    check_tensor("go", go, u.device, torch.float32, (batch, L, dim))
    check_tensor("boundaries", boundaries, u.device, torch.float32,
                 (batch, n_chunks, n_state, dim))
    dev = u.device
    parts, groups = -(-dim // _BWD_TILE), -(-n_chunks // _BWD_GROUP)
    # the carry pass's w, in tiles of 8 channels: (batch, n_chunks,
    # ceil(dim / 8), N, 8)
    w = torch.empty(batch, n_chunks, -(-dim // 8) * n_state * 8, device=dev)
    # du and ddt a slice a tile of 32 states (the split entries')
    tiles = _tiles(n_state)
    du_t = torch.empty(tiles, batch, L, dim, device=dev)
    ddt_t = torch.empty_like(du_t)
    dB_p = torch.empty(parts, batch, L, n_state, device=dev)
    dC_p = torch.empty(parts, batch, L, n_state, device=dev)
    dA_p = torch.empty(batch, groups, dim, n_state, device=dev)
    dh0 = (torch.empty(batch, dim, n_state, device=dev),) if return_dh0 \
        else ()
    flags = (DTYPE_CODE[u.dtype], int(bool(delta_softplus)))
    outs = (boundaries, w, du_t, ddt_t, dB_p, dC_p, dA_p)
    counts = selective_scan_bwd_core_cuda
    if dt_w is None:
        _launch("selective_scan_bwd", dev,
                (u, dt_low, A, B, C, delta_bias, go, *outs),
                (batch, L, dim, n_state, *flags), entry="delta")
        counts.delta_launches += 1
    elif n_state > _TILE:
        _launch("selective_scan_bwd", dev,
                (u, dt_low, dt_w, A, B, C, delta_bias, go, *outs,
                 dh0[0] if dh0 else None),
                (batch, L, dim, n_state, dt_w.shape[0], *flags),
                entry="split")
        counts.split_launches += 1
    else:
        _launch("selective_scan_bwd", dev,
                (u, dt_low, dt_w, A, B, C, delta_bias, go, *outs, *dh0),
                (batch, L, dim, n_state, dt_w.shape[0], *flags),
                entry="h0" if dh0 else None)
    du_s, ddt = ((du_t[0], ddt_t[0]) if tiles == 1
                 else (du_t.sum(0), ddt_t.sum(0)))
    counts.launches += 1
    counts.h0_launches += bool(dh0)
    return (du_s, ddt, dA_p.sum((0, 1)), dB_p.sum(0), dC_p.sum(0)) + dh0


selective_scan_bwd_core_cuda.launches = 0
selective_scan_bwd_core_cuda.h0_launches = 0
selective_scan_bwd_core_cuda.split_launches = 0
selective_scan_bwd_core_cuda.delta_launches = 0


def selective_scan_fwd_train(u, dt_low, dt_w, A, B, C, D=None, z=None,
                             delta_bias=None, delta_softplus=False, h0=None):
    """Kernel 2 for CUDA tensors, its plain version for CPU tensors."""
    fn = selective_scan_fwd_train_cuda if u.is_cuda else \
        selective_scan_fwd_train_ref
    return fn(u, dt_low, dt_w, A, B, C, D, z, delta_bias, delta_softplus,
              h0=h0)


def selective_scan_bwd(u, dt_low, dt_w, A, B, C, D=None, z=None,
                       delta_bias=None, delta_softplus=False, *, o,
                       boundaries, g, h0=None):
    """`selective_scan_bwd_ref` with its reverse scan on kernel 3 for CUDA
    tensors (on the plain version for CPU tensors)."""
    core = selective_scan_bwd_core_cuda if u.is_cuda else \
        selective_scan_bwd_core_ref
    return _bwd(core, u, dt_low, dt_w, A, B, C, D, z, delta_bias,
                delta_softplus, o, boundaries, g, h0=h0)


class SelectiveScanDtLowFn(torch.autograd.Function):
    """selective_scan(u, dt_low @ dt_w, ...) with the JAX package's training
    rules (`_dtlow_fwd`/`_dtlow_bwd`, selective_scan.py:812-835): the
    forward saves o and the chunk-start states, the backward replays them;
    ddelta goes back through the expansion as two fp32 products,
    ddt_low = ddelta @ dt_w^T and ddt_w = dt_low^T @ ddelta.

    An optional last input `h0` (batch, dim, N) float32 seeds the state
    before step 0 (the kernels' h0 entries), and its gradient dh0 comes
    back.  This is the port's training route for the JAX XLA route
    `selective_scan_xla(u, dt_low @ dt_w, ..., h0=h0)` (mamba.py:234-250),
    which JAX differentiates by autograd: the expansion stays in fp32
    inside the kernels, as on the h0-free route (in bf16 JAX rounds delta
    to bf16 first; ROADMAP Queue 3, "kept by design")."""

    @staticmethod
    def forward(ctx, u, dt_low, dt_w, A, B, C, D, z, delta_bias,
                delta_softplus, h0=None):
        # a remat site: a replay under a policy that keeps scan_out gets
        # the first forward's outputs back instead of a launch
        y, o, bnd = remat.kernel_outputs("scan_out", lambda: (
            selective_scan_fwd_train(u, dt_low, dt_w, A, B, C, D, z,
                                     delta_bias, delta_softplus, h0=h0)))
        ctx.delta_softplus = delta_softplus
        ctx.save_for_backward(u, dt_low, dt_w, A, B, C, D, z, delta_bias,
                              o, bnd, h0)
        return y

    @staticmethod
    def backward(ctx, g):
        u, dt_low, dt_w, A, B, C, D, z, delta_bias, o, bnd, h0 = \
            ctx.saved_tensors
        grads = selective_scan_bwd(
            u, dt_low, dt_w, A, B, C, D, z, delta_bias, ctx.delta_softplus,
            o=o, boundaries=bnd, g=g.contiguous(), h0=h0)
        du, ddelta, dA, dB, dC, dD, dz, dbias = grads[:8]
        dd = ddelta.float()
        ddt_low = torch.matmul(dd, dt_w.float().t()).to(dt_low.dtype)
        ddt_w = torch.einsum("blr,bld->rd", dt_low.float(), dd).to(
            dt_w.dtype)
        out = (du, ddt_low, ddt_w, dA, dB, dC, dD, dz, dbias, None,
               grads[8] if h0 is not None else None)
        return out[:len(ctx.needs_input_grad)]  # h0 may not have been given


def selective_scan_dtlow_train(u, dt_low, dt_w, A, B, C, D=None, z=None,
                               delta_bias=None, delta_softplus=False,
                               reverse: bool = False, h0=None):
    """`SelectiveScanDtLowFn`, with `reverse` as flips around it (autograd
    differentiates the flips), as `_dtlow_fwd`/`_dtlow_bwd` do; `h0` then
    seeds the reversed walk.  Kernels 2 and 3 for CUDA tensors, their
    plain versions for CPU tensors."""
    if reverse:
        u, dt_low, B, C, z = (_flip(u), _flip(dt_low), _flip(B), _flip(C),
                              _flip(z))
    y = SelectiveScanDtLowFn.apply(u, dt_low, dt_w, A, B, C, D, z,
                                   delta_bias, delta_softplus, h0)
    return _flip(y) if reverse else y


class SelectiveScanFn(torch.autograd.Function):
    """selective_scan(u, delta, ...) with a full delta and the JAX Pallas
    route's training rules (`_pallas_fwd` / `_pallas_bwd`,
    selective_scan.py:749-785): kernel 2's delta entry saves o and the
    chunk-start states, kernel 3's delta entry replays them; ddelta comes
    back in delta's dtype and dbias as the sum of ddt, as in `_bwd`.  CPU
    tensors take the pair's plain versions."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, z, delta_bias, delta_softplus):
        y, o, bnd = selective_scan_fwd_train(u, delta, None, A, B, C, D, z,
                                             delta_bias, delta_softplus)
        ctx.delta_softplus = delta_softplus
        ctx.save_for_backward(u, delta, A, B, C, D, z, delta_bias, o, bnd)
        return y

    @staticmethod
    def backward(ctx, g):
        u, delta, A, B, C, D, z, delta_bias, o, bnd = ctx.saved_tensors
        grads = selective_scan_bwd(u, delta, None, A, B, C, D, z, delta_bias,
                                   ctx.delta_softplus, o=o, boundaries=bnd,
                                   g=g.contiguous())
        return (*grads, None)


class SelectiveScanGroupedFn(torch.autograd.Function):
    """Grouped B/C (batch, L, G, N) with a gradient, the JAX
    `_selective_scan_pallas_grouped` (selective_scan.py:893-920): the
    forward on the state entry's grouped case, the backward recomputed
    through the plain scan under autograd (`_grouped_bwd`, which takes the
    XLA scan's VJP).  An optional h0 seeds the state, as the plain scan's
    (the port's dt_low route with `use_cond_init`)."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, z, delta_bias, delta_softplus,
                h0=None):
        ctx.delta_softplus = delta_softplus
        ctx.save_for_backward(u, delta, A, B, C, D, z, delta_bias, h0)
        return selective_scan_state(u, delta, A, B, C, D, z, delta_bias,
                                    delta_softplus, h0=h0)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        # the inputs' flags without delta_softplus's (h0 may not be given)
        flags = ctx.needs_input_grad[:8] + (ctx.needs_input_grad[9:] or
                                            (False,))
        want = [t is not None and need for t, need in zip(saved, flags)]
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(w)
                      for t, w in zip(saved, want)]
            u, delta, A, B, C, D, z, bias, h0 = inputs
            y = selective_scan_ref(u, delta, A, B, C, D, z, bias,
                                   ctx.delta_softplus, h0=h0)
            wrt = [t for t, w in zip(inputs, want) if w]
            got = iter(torch.autograd.grad(y, wrt, g) if wrt else ())
        grads = [next(got) if w else None for w in want]
        return (*grads[:8], None, grads[8])[:len(ctx.needs_input_grad)]


def selective_scan(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                   delta_softplus=False, return_last_state=False,
                   impl: Optional[str] = None):
    """The JAX `selective_scan` front end (selective_scan.py:969-987): a
    full delta (batch, L, dim) in u's dtype, B/C (batch, L, N) or grouped
    (batch, L, G, N); returns y, and with `return_last_state` also the
    state after the last step, (batch, dim, N) fp32.

    `impl`: None takes the kernels for CUDA tensors and the plain version
    for CPU tensors; "ref" the plain version on any device, differentiated
    by autograd (the JAX XLA route); "cuda" the kernels, which raises for
    CPU tensors.  On the kernel route, with no input needing a gradient the
    state entry runs (`selective_scan_state_cuda`, grouped or not); with
    one, `SelectiveScanFn` (kernels 2 and 3's delta entries, the JAX
    `_selective_scan_pallas`), or for grouped B/C `SelectiveScanGroupedFn`;
    `return_last_state` with a gradient runs the plain scan under autograd,
    as JAX sends it to its XLA scan (:927-931).  A shape the kernels do not
    take raises."""
    if impl is None:
        impl = "cuda" if u.is_cuda else "ref"
    args = (u, delta, A, B, C, D, z, delta_bias, delta_softplus)
    if impl == "ref":
        return selective_scan_ref(*args, return_last_state=return_last_state)
    if impl != "cuda":
        raise ValueError(f"unknown selective scan impl {impl!r}")
    if not u.is_cuda:
        raise ValueError("impl='cuda' takes CUDA tensors only")
    if not needs_grad(u, delta, A, B, C, D, z, delta_bias):
        return selective_scan_state_cuda(
            *args, return_last_state=return_last_state)
    if return_last_state:
        return selective_scan_ref(*args, return_last_state=True)
    if B.ndim == 4:
        return SelectiveScanGroupedFn.apply(*args)
    return SelectiveScanFn.apply(*args)


def _selective_scan_grouped_dtlow(u, dt_low, dt_w, A, B, C, D, z, delta_bias,
                                  delta_softplus, reverse, h0):
    """`selective_scan_dtlow` on the kernel route with grouped B/C, as the
    JAX `selective_scan_dtlow` sends a 4-D B (selective_scan.py:862-876):
    delta = dt_low @ dt_w in the compute dtype, then `selective_scan`
    (flipped around it for `reverse`); with h0 the state entry, or under a
    gradient `SelectiveScanGroupedFn` with h0."""
    delta = torch.matmul(dt_low, dt_w)
    if reverse:
        u, delta, B, C, z = (_flip(u), _flip(delta), _flip(B), _flip(C),
                             _flip(z))
    args = (u, delta, A, B, C, D, z, delta_bias, delta_softplus)
    if h0 is None:
        y = selective_scan(*args, impl="cuda")
    elif needs_grad(*args[:8], h0):
        y = SelectiveScanGroupedFn.apply(*args, h0)
    else:
        y = selective_scan_state_cuda(*args, h0=h0)
    return _flip(y) if reverse else y


def selective_scan_dtlow(u, dt_low, dt_w, A, B, C, D=None, z=None,
                         delta_bias=None, delta_softplus=False,
                         reverse: bool = False, impl: Optional[str] = None,
                         h0=None):
    """selective_scan(u, dt_low @ dt_w, ...), the JAX `selective_scan_dtlow`.

    `dt_low` (batch, L, r) is the dt_proj input and `dt_w` (r, dim) its
    weight; the expansion is computed in fp32 (as the Pallas kernel does on
    its MXU).  `reverse=True` computes flip_L(scan(flip_L(inputs))).

    `impl`: None takes the CUDA kernels for CUDA tensors and the plain
    version for CPU tensors; "ref" takes the plain version on any device,
    differentiated by autograd, `reverse` as flips around it (the JAX XLA
    route); "cuda" takes the kernels and raises for CPU tensors.  On the
    kernel route, kernel 1 runs when no input needs a gradient (no_grad,
    inference_mode, or frozen inputs), `reverse` on its reverse entry with
    no flip (the JAX Pallas inference route), and
    `selective_scan_dtlow_train` (kernels 2 and 3, between flips for
    `reverse`, as `_dtlow_fwd`/`_dtlow_bwd`) when one does.  There is no
    fallback: a shape or dtype the kernels do not take raises.

    `h0` (batch, dim, N) float32 seeds the state before step 0: the JAX
    mixer's `use_cond_init` route, `selective_scan_xla(u, dt_low @ dt_w,
    ..., h0=h0)` with delta materialized in the compute dtype
    (mamba.py:234-250).  The plain route materializes delta so, and so
    does the kernel route without a gradient, which takes the state entry
    (`selective_scan_state_cuda`, h0 in); with a gradient it takes
    `selective_scan_dtlow_train` with h0 (kernels 2 and 3's h0 entries,
    the expansion in fp32).  With h0, `reverse` raises, as in JAX
    (selective_scan.py:592-593): the mixer flips around the seeded scan
    instead.

    Grouped B/C (batch, L, G, N) on the kernel route expands delta in the
    compute dtype and takes `selective_scan`, as the JAX function does
    (`_selective_scan_grouped_dtlow`)."""
    if impl is None:
        impl = "cuda" if u.is_cuda else "ref"
    if h0 is not None and reverse:
        raise NotImplementedError("reverse scan with h0: flip the inputs "
                                  "and the output around the seeded scan")
    if impl == "cuda" and B.ndim == 4:
        if not u.is_cuda:
            raise ValueError("impl='cuda' takes CUDA tensors only")
        return _selective_scan_grouped_dtlow(
            u, dt_low, dt_w, A, B, C, D, z, delta_bias, delta_softplus,
            reverse, h0)
    if h0 is not None and impl in ("cuda", "ref"):
        if impl == "cuda" and not u.is_cuda:
            raise ValueError("impl='cuda' takes CUDA tensors only")
        if impl == "cuda" and needs_grad(u, dt_low, dt_w, A, B, C, D, z,
                                         delta_bias, h0):
            return selective_scan_dtlow_train(
                u, dt_low, dt_w, A, B, C, D=D, z=z, delta_bias=delta_bias,
                delta_softplus=delta_softplus, h0=h0)
        delta = torch.matmul(dt_low, dt_w)  # in the compute dtype
        if impl == "cuda":
            return selective_scan_state_cuda(
                u, delta, A, B, C, D, z, delta_bias, delta_softplus, h0=h0)
        with remat.tag("scan_out"):
            return selective_scan_ref(u, delta, A, B, C, D=D, z=z,
                                      delta_bias=delta_bias,
                                      delta_softplus=delta_softplus, h0=h0)
    if impl == "cuda":
        if not u.is_cuda:
            raise ValueError("impl='cuda' takes CUDA tensors only")
        if needs_grad(u, dt_low, dt_w, A, B, C, D, z, delta_bias):
            return selective_scan_dtlow_train(
                u, dt_low, dt_w, A, B, C, D=D, z=z, delta_bias=delta_bias,
                delta_softplus=delta_softplus, reverse=reverse)
        return selective_scan_cuda(u, dt_low, dt_w, A, B, C, D=D, z=z,
                                   delta_bias=delta_bias,
                                   delta_softplus=delta_softplus,
                                   reverse=reverse)
    if impl != "ref":
        raise ValueError(f"unknown selective scan impl {impl!r}")
    if reverse:
        u, dt_low, B, C, z = (_flip(u), _flip(dt_low), _flip(B), _flip(C),
                              _flip(z))
    with remat.tag("scan_out"):
        delta = torch.einsum("blr,rd->bld", dt_low.float(), dt_w.float())
        y = selective_scan_ref(u, delta, A, B, C, D=D, z=z,
                               delta_bias=delta_bias,
                               delta_softplus=delta_softplus)
    return _flip(y) if reverse else y


def selective_state_update(state, x, dt, A, B, C, D=None, z=None,
                           dt_bias=None, dt_softplus=False):
    """One decode step of the recurrence (the JAX `selective_state_update`,
    plain jnp there and plain PyTorch here; the reference's Triton
    kernel): state (batch, dim, N); x, dt, z (batch, dim); B, C (batch,
    N); A (dim, N).  In fp32: dt (+ bias, softplus), h = exp(dt A) h +
    dt x B, y = <h, C> + D x, times silu(z).  Returns (y in x's dtype, the
    new state in state's dtype)."""
    dtf = dt.float()
    if dt_bias is not None:
        dtf = dtf + dt_bias.float()
    if dt_softplus:
        dtf = softplus(dtf)
    dA = torch.exp(dtf[..., None] * A.float())
    dB = dtf[..., None] * B.float()[:, None, :]
    new_state = state.float() * dA + x.float()[..., None] * dB
    y = torch.einsum("bdn,bn->bd", new_state, C.float())
    if D is not None:
        y = y + D.float() * x.float()
    if z is not None:
        zf = z.float()
        y = y * (zf * torch.sigmoid(zf))
    return y.to(x.dtype), new_state.to(state.dtype)
