"""Least times of the port's kernels from their shapes, against one H100's
published peaks.

Frozen from `chip_smoke.py` at commit 47e520a: the peaks, `_bound`,
`_expansion_flops`, `scan_bound`, `train_bounds`, `attn_bound`,
`norm_bound` and `convx_bound`, unchanged.  Each counts the algorithm's
work (each input read once, each output written once, the operations the
mathematics needs), not what a kernel happens to do.  The scan and
training bounds read only `.shape`, `.numel()` and `.element_size()` of
their inputs, so tensors on the meta device serve (`scan_args`).
"""

from __future__ import annotations

import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12
TF32_TC_FLOP_PER_S = 495e12
# exp on the special-function units: 16 per SM per clock (CUDA programming
# guide, sm_90), 132 SMs at the 1.98 GHz boost clock
SFU_EXP_PER_S = 16 * 132 * 1.98e9
TRAIN_CHUNK = 16  # the training kernels' chunk of steps


def _bound(nbytes, flops, n_sfu, tc_flops=0):
    """(bound ms, "bytes" or "operations", which operations): the largest
    of the bytes over HBM bandwidth, the fp32 operations over the fp32
    peak, the transcendentals over the special-function units and the
    bf16 tensor-core operations (`tc_flops`) over their peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    times = {"fp32": flops / FP32_FLOP_PER_S * 1e3,
             "sfu": n_sfu / SFU_EXP_PER_S * 1e3,
             "bf16_tc": tc_flops / BF16_TC_FLOP_PER_S * 1e3}
    ops = max(times, key=times.get)
    if t_bytes >= times[ops]:
        return t_bytes, "bytes", None
    return times[ops], "operations", ops


def _expansion_flops(x, per_elem):
    """(fp32 flop, bf16 tensor-core flop) of a scan kernel on x: the dt
    expansion's 2r a (b, t, d) runs on the tensor cores (mma.sync) for
    bf16 inputs and as fp32 FMAs for fp32 ones; `per_elem` more fp32 flop
    a (b, t, d) besides.  A full delta (x["delta"]) has no expansion."""
    batch, L, dim = x["u"].shape
    if "delta" in x:
        return batch * L * dim * per_elem, 0
    big, two_r = batch * L * dim, 2 * x["dt_w"].shape[0]
    if x["u"].element_size() == 2:
        return big * per_elem, big * two_r
    return big * (two_r + per_elem), 0


def scan_bound(x):
    """Least time for one scan call: each input read once and the output
    written once, over HBM bandwidth; the operations, 2r (dt expansion:
    fp32 FMAs, or bf16 tensor-core products for bf16 inputs) + 7N (per
    state: dt*A, exp2, du*B, two FMAs) + 12 (bias, softplus, du, skip,
    gate) per (b, t, d), each over its unit's peak; and the N + 3
    transcendentals per (b, t, d) (an exp2 per state; exp and log in
    softplus; exp in the gate) over the special-function units.  Returns
    (ms, bound_by, which operations, bytes, flop, transcendentals, bf16
    tensor-core flop)."""
    batch, L, dim = x["u"].shape
    n = x["A"].shape[1]
    nbytes = sum(v.numel() * v.element_size() for v in x.values())
    nbytes += x["u"].numel() * x["u"].element_size()  # the output
    flops, tc = _expansion_flops(x, 7 * n + 12)
    n_sfu = batch * L * dim * (n + 3)
    return (*_bound(nbytes, flops, n_sfu, tc), nbytes, flops, n_sfu, tc)


def train_bounds(x, chunk, h0=False):
    """Least time of the two training kernels on x's shapes: each input
    read once and each output written once over HBM bandwidth, the fp32
    operations over the fp32 peak (the dt expansion's 2r over the bf16
    tensor-core peak for bf16 inputs), and the transcendentals over the
    special-function units (`_bound`).  Kernel 2: kernel 1's inputs, y
    (u's type), o and the states (fp32); 2r + 7N + 12 flop and N + 3
    transcendentals per (b, t, d), as kernel 1.  Kernel 3 (with its partial
    sums): u, dt_low, dt_w, A, B, C, bias, go and the states in, du, ddt
    (fp32) and dA, dB, dC out; 2r + 20N + 18 flop per (b, t, d) and N + 3
    transcendentals.  With `h0` kernel 2 also reads h0 and kernel 3 writes
    dh0, (batch, dim, N) fp32 each.  With a full "delta" in x it is read in
    place of dt_low and dt_w, and there is no expansion."""
    batch, L, dim = x["u"].shape
    n = x["A"].shape[1]
    esize = x["u"].element_size()
    n_chunks = -(-L // chunk)
    big, small = batch * L * dim, batch * L * n
    dt_in = (x["delta"].numel() if "delta" in x
             else x["dt_low"].numel() + x["dt_w"].numel())
    common = (x["u"].numel() + dt_in
              + 2 * small) * esize + x["A"].numel() * 4 + dim * 4
    states = batch * n_chunks * n * dim * 4
    seed = batch * dim * n * 4 if h0 else 0
    fwd_bytes = (common + x["z"].numel() * esize + dim * 4  # z, D
                 + big * esize + big * 4 + states + seed)   # y, o, states
    bwd_bytes = (common + big * 4 + states                  # go, states
                 + 2 * big * 4 + dim * n * 4 + 2 * small * 4 + seed)
    out = {}
    for name, nbytes, (flops, tc), n_sfu in (
            ("fwd_train", fwd_bytes, _expansion_flops(x, 7 * n + 12),
             big * (n + 3)),
            ("bwd", bwd_bytes, _expansion_flops(x, 20 * n + 18),
             big * (n + 3))):
        out[name] = (*_bound(nbytes, flops, n_sfu, tc), nbytes, flops,
                     n_sfu, tc)
    return out


def attn_bound(B, L, H, Dh, dtype):
    """Least time for one full-block attention call: q, k, v read once and
    o written once over HBM bandwidth; 4 L^2 Dh flop per (batch, head) (the
    two products) over the tensor-core bf16 peak, or for fp32 the lesser
    of the fp32 peak and three TF32 tensor-core products over the TF32
    peak; and the L^2 exp per (batch, head) over the special-function
    units.  The largest bounds."""
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * B * L * H * Dh * esize
    flops = 4 * B * H * L * L * Dh
    n_exp = B * H * L * L
    if dtype == torch.bfloat16:
        t_flops = flops / BF16_TC_FLOP_PER_S
    else:
        t_flops = min(flops / FP32_FLOP_PER_S, 3 * flops / TF32_TC_FLOP_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(t_flops, n_exp / SFU_EXP_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops, n_exp


def norm_bound(numel, rows, d, esize, flags):
    """Least time for one add + norm or norm + modulate call: each input
    read once and each output written once over HBM bandwidth, against the
    fp32 operations per value (2 for the moment, 2 to normalize, 2 more for
    LayerNorm's centred variance, 1 for each present gate, branch, residual,
    weight and bias, 3 for the modulation) over the fp32 peak.  `flags`
    maps each operand to its element size in bytes (absent: 0)."""
    per_row = sum(flags.get(k, 0) for k in ("branch", "res", "total"))
    per_batch = sum(flags.get(k, 0) for k in ("gate", "shift", "scale"))
    per_chan = flags.get("w", 0) + flags.get("b", 0)
    nbytes = (numel * (2 * esize + per_row) + rows * per_batch * d
              + per_chan * d)
    ops = 4 + 2 * (not flags["rms"]) + sum(
        1 for k in ("branch", "gate", "res", "w", "b") if flags.get(k)) + (
        3 if flags.get("shift") else 0)
    flops = numel * ops
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def convx_bound(B, L, D, W, R, esize, peak):
    """Least time for one conv + x_proj call: x read once, x_conv and x_dbl
    (fp32) written once, the weights read once, over HBM bandwidth; against
    the product's 2 B L D R flop at `peak` (tensor cores for bf16, the fp32
    peak for fp32) plus the conv's 2 W + 5 fp32 operations per value (taps,
    bias, SiLU)."""
    nbytes = (2 * B * L * D * esize + B * L * R * 4 + D * (W + 1) * 4
              + R * D * esize)
    flops = 2 * B * L * D * R + B * L * D * (2 * W + 5)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (2 * B * L * D * R / peak
             + B * L * D * (2 * W + 5) / FP32_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def scan_args(batch, L, dim, n, r, dtype, device="meta"):
    """The scan's inputs as `chip_smoke.scan_inputs` lays them out (fp32
    A, D and delta_bias; the rest in `dtype`), empty on `device`."""
    def e(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=device)

    return dict(u=e(batch, L, dim), dt_low=e(batch, L, r), dt_w=e(r, dim),
                A=e(dim, n, dt=torch.float32), B=e(batch, L, n),
                C=e(batch, L, n), D=e(dim, dt=torch.float32),
                z=e(batch, L, dim), delta_bias=e(dim, dt=torch.float32))
