#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`dimsum_torch`) on one NVIDIA card:
its sampling and training paths at full DiM-L/2 width, at 256 px and, for
sampling, at 512 px (also sequence-parallel over 4 ranks on the card), and
sampling from a checkpoint by the reference's eval protocol through
`python -m dimsum_torch.sample`.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

  1. device   the card's name and power limit (nvidia-smi).
  2. build    nvcc builds every kernel source of the port (one process per
              source, all started together) into build/dimsum_torch/.
  3. kernel   the selective-scan kernel against its plain PyTorch version
              at the DiM-L/2 mixer shape (batch 24, L 256, dim 1024, N 16,
              r 32) in bf16 and fp32, forward and reversed, plus a ragged
              dim and L 1024 (the 512-px mixer): max error against the
              stated tolerance, kernel and plain times (CUDA events), and
              the bound (bytes, fp32 operations and the transcendentals on
              the special-function units, the largest).
  4. model    full-width DiM-L/2 at 256 px (depth 16, seeded random
              weights), one CFG forward in fp32 with TF32 off through the
              kernel and through the plain scan: they must agree, and the
              kernel must launch exactly 32 times per forward.
  5. sample   the sampling path: `dimsum_torch.bench.run` (batch 12, CFG
              1.4, GVP velocity, 250 Euler grid points, bf16).  Launch
              counts are set to 0 just before and read just after; the
              samples must be finite.
  6. kernel-train  the training pair, kernels 2 (forward with saved
              states: its state pass and main pass) and 3 (backward: its
              carry pass and main pass), against their plain versions at
              the training mixer shape (batch 16, L 256, dim 1024, N 16, r
              32) in bf16 and fp32, forward and reversed, plus a ragged
              dim, at the 512-px one (batch 4, L 1024) in bf16 and fp32,
              and at a ragged L (4 x 1000, bf16): max error against the
              stated tolerance, kernel and plain times, and the bound.
  7. train-grad  full-width DiM-L/2 in fp32 with TF32 off at batch 2, one
              training loss (label dropout 0.1, stochastic depth 0.1, the
              same seeded draws) through the kernels and through the plain
              scan: the loss and every parameter's gradient must agree, and
              kernels 2 and 3 must each launch 32 times.
  8. train    the training path: `dimsum_torch.train_bench.run` (DiM-L/2,
              batch 16, bf16 over fp32 weights, AdamW, clip 1.0, EMA), 10
              timed steps after 3 of warm-up.  Counts set to 0 just before and
              read just after: 32 launches per step of kernels 2 and 3, none
              of kernel 1; finite losses and grad norms; the parameters and
              their EMA move.
  9. train-512  the 512-px training path: `train_bench.run` at 512 px
              (DiM-L/2, batch 4, bf16), 3 timed steps after 1 of warm-up;
              counts set to 0 just before and read just after: 32 launches
              per step of kernels 2 and 3, none of kernel 1; finite losses
              and grad norms.
 10. kernel-attn  the full-block attention kernels against their plain
              PyTorch version at the 512-px shapes, DiT (24, 1024, 16, 64)
              and cross (24, 1024, 8, 64): bf16 through the sm90 kernel
              (TMA + wgmma, csrc/full_attention_sm90.cu), fp32 through the
              fp32 kernel (csrc/full_attention_f32.cu: S on the FP32 pipe,
              P V as three TF32 tensor-core products); each record names
              the kernel that ran.  Max error against the stated tolerance,
              kernel, plain and SDPA times (SDPA is a yardstick only: the
              port never calls it at these shapes; its device time too),
              and the bound; also the first kernel (csrc/full_attention.cu)
              in the same dtype, held to the same tolerance and timed on the
              same inputs.  Then q and k 40x at the DiT shape (logits
              ~1e3) in both dtypes, at the same tolerances.  Plus the
              autograd Function's gradient against the plain version's at
              a small shape.
 11. model-512  full-width DiM-L/2 at 512 px (latent 64, L 1024) in fp32
              with TF32 off, one CFG forward of 2 images (4 rows) through
              both kernels (scan and attention) and through both plain
              routes: they must agree, with 36 attention (all through the
              fp32 kernel) and 32 scan launches per forward.
 12. model-512-bf16  the same forward in bf16 at three seeds of inputs,
              its q and k projections scaled by 4 so that attention is
              peaked, through the sm90 attention kernel and through the
              plain attention (the scan kernel on both sides): they must
              agree within MODEL_512_BF16_TOL, with 36 sm90 launches; and
              each of the 36 calls, on the inputs the model gave it, within
              the kernel tolerance of the plain version.  Two faulty
              attentions (no online rescale; the last key tile dropped)
              must miss both limits.
 13. sample-512  the 512-px sampling path: `dimsum_torch.bench.run`
              with image_size 512 (batch 12, CFG 1.4, GVP velocity, 250
              Euler grid points, bf16).  Counts set to 0 just before and
              read just after: 32 scan and 36 attention launches per
              forward, all 36 through the sm90 kernel; the samples must be
              finite.
 14. kernel-state  the scan's state entry (csrc/selective_scan_fwd.cu's
              second entry: a full delta, h0, the last state) against its
              plain version at the sample-sp-512 shape (8, 256, 1024, N 16,
              delta = dt_low @ dt_w with r 32 in the compute dtype) in bf16
              and fp32, and at a ragged L and dim (8, 250, 1000): both SP
              passes (zero state in and the last state out; seeded from an
              h0), max error against the stated tolerance, kernel, device
              and plain times, and the bound.
 15. sample-sp-512  DiM-L/2 at 512 px sequence-parallel: SP_RANKS = 4
              processes on the one card (gloo, tcp://localhost), 256 of the
              1024 tokens a rank in every mixer (halo conv, two-pass scan
              through the state entry), the seeded weights of sample-512:
              one fp32 CFG drift call of 8 rows (TF32 off) against the
              unsharded forward (scaled error <= SP_512_FP32_TOL), then
              SP_STEPS Euler grid points with CFG 1.4 in bf16 against the
              unsharded run (<= SP_512_BF16_TOL).  Counts set to 0 just
              before and read just after on every rank: 2 x 32 state-entry
              and 36 attention launches a drift call (the fp32 call's
              through the fp32 kernel, the bf16 calls' through sm90), none
              of kernel 1.  Records the wall time a drift call, the unsharded one's,
              and the all_gathers' share of a call, in all and by kind
              (halos, summaries, outputs; timed between synchronizations
              in one more call).
 16. kernel-norm  the add + norm and norm + modulate kernels against their
              plain PyTorch versions at the 256-px rows (24 x 256 x 1024):
              the add + norm site and every norm + modulate call site
              (norm_2, the DiT block's two LayerNorms, the FinalLayer's,
              the deferred top of the pending tail), bf16 and fp32: max
              error against the stated tolerance, kernel and plain times,
              and the bound; bf16 norm_2 also with a cold L2 (128 MB
              written before each launch), and norm_2 and the DiT block's
              second LayerNorm at the 512-px rows (24 x 1024 x 1024).
              Alone: python3 -c "import chip_smoke as s;
              s.phase_kernel_norm()".
 17. kernel-convx  the conv + x_proj kernel against its plain version at the
              mixer shape (24, 256, 1024, W 4, R 64, x a strided slice of
              in_proj's output), forward and reversed, bf16 and fp32, plus
              L 1024, DiM-XL/2's R 68, ragged L (65, 127 reversed) and the
              gate's widest R (512): the same fields.
 18. model-fused  full-width DiM-L/2 at 256 px in fp32 with TF32 off, one
              CFG forward with the fused-kernel switches on (pallas_norm,
              fused_norm, conv_xproj) through the kernels and through their
              plain versions, and with the switches off: all must agree, at
              pending_tail 0 (15 add + norm, 25 norm + modulate, 32 conv +
              x_proj launches per forward) and 2 (3, 37, 32).
 19. train-grad-fused  phase 7's training gradient with the three switches
              on, through the kernels and through their plain versions:
              the loss and every gradient must agree; one forward's
              launches, none from the backward.
 20. sample-fused  phase 5's sampling run with the three switches on.
              Counts set to 0 just before and read just after: 15, 25 and
              32 launches per forward; the samples must be finite.
 21. sample-fused-512  phase 20's run at 512 px: 15, 25 and 32 fused
              and 36 sm90 attention launches per forward; finite samples.
 22. sample-dopri5  the sampling path from a checkpoint: seeded random
              DiM-L/2 weights written in the reference's .pt layout (a
              different "ema" and "model") and a full-width SD-VAE (ch 128,
              ch_mult 1 2 4 4) with seeded random weights written as a
              diffusers state dict, both into a temporary directory; then
              `python -m dimsum_torch.sample ODE` (dopri5, --compute-nfe,
              CFG 1.4, 256 px, bf16, DOPRI5_BATCH images, VAE decode to
              PNGs).  Counts set to 0 just before and read just after: 32
              launches of kernel 1 per drift call, NFE + 1 calls; one 256 x
              256 PNG per image; finite latents.  `--params ema|raw` must
              take the matching weights, and a checkpoint with one key
              removed must be refused.  Prints the NFE, the seconds and the
              decode seconds.
 23. sample-sde-512  the checkpoint adapted to 512 px (`adapt_checkpoint`)
              and sampled by the CLI's SDE mode (Euler-Maruyama over
              SDE_512_STEPS grid points, CFG 1.4, bf16): 32 scan and 36 sm90
              attention launches per model call; finite samples.
 24. sample-512-fp32  the adapted checkpoint sampled by the CLI's ODE
              mode in its default dtype, fp32 (TF32 off; Euler over
              FP32_512_STEPS grid points, CFG 1.4, 2 images): 32 scan and
              36 attention launches per drift call, all through the fp32
              kernel; finite samples.
 25. likelihood  the CLI's `--likelihood` at cfg 1.0 (256 px, bf16, 2
              images, LIKELIHOOD_STEPS grid points): 32 launches of kernels
              2 and 3 per drift call of the augmented ODE, finite bits/dim;
              and one augmented drift call of the fp32 model (TF32 off)
              through the kernels and through the plain scan: they must
              agree.
 26. kernels  one {"kernels": [...]} line (all ten kernels; the scan,
              both training kernels, conv + x_proj and norm + modulate
              (norm_2) with their L 1024 times and bound beside the
              256-px ones (norm + modulate also with its L2-cold device
              time, `cold_device_ms`), the scan's
              state entry with its second SP pass's (h0) beside its first's,
              the three attention kernels with their cross-shape times
              beside the DiT ones; the first attention kernel, on no main
              path now, with 0 launches, its times from the fp32 cases),
              then the nvidia-smi line, then {"ok": true, "device": {...}}
              as the last line.  Each record's `ms` (CUDA events around
              back-to-back launches, which below ~0.05 ms can read the
              host's launch gaps) has `device_ms` beside it: the median
              duration of the kernel's launches in torch.profiler's CUDA
              activity over the same launches.

Exits with an error and prints no result when CUDA is not available, or
when the port's package is not beside this script.
"""

from __future__ import annotations

import json
import math
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12
TF32_TC_FLOP_PER_S = 495e12
# exp on the special-function units: 16 per SM per clock (CUDA programming
# guide, sm_90), 132 SMs at the 1.98 GHz boost clock
SFU_EXP_PER_S = 16 * 132 * 1.98e9
STEPS = 250  # Euler grid points of the bench protocol
# timed and untimed steps of the train phase, as train_bench's defaults
TRAIN_STEPS, TRAIN_WARMUP = 10, 3
# timed steps of the 512-px train phase (after one of warm-up)
TRAIN_512_STEPS = 3


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def held_stream_ms(fn, iters: int = 20, hold_ms: float = 20.0) -> float:
    """Device time per call of `fn` by CUDA events around `iters` calls
    queued behind a spin kernel that holds the stream for `hold_ms`, so
    the host has queued every launch before the first one runs and the
    calls run back to back: the host's launch gaps, which `cuda_ms` reads,
    are left out.  It times every kernel `fn` launches."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # cycles at the 1.98 GHz boost clock: at a lower clock it holds longer
    torch.cuda._sleep(int(hold_ms * 1.98e6))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, cls, iters: int = 20, tries: int = 5) -> float:
    """Device time per call of `fn` in the kernels of `profile_forward`'s
    class `cls` (None: every kernel), from torch.profiler's CUDA activity over `iters` calls
    after one untimed: the kernels alone, without the host's launch gaps,
    which `cuda_ms` reads below ~0.05 ms.  Each kernel of the class (one
    launch a call each) counts with the median of its launches' durations,
    those of zero length left out: in a process that has run many profiler
    sessions, some sessions record only part of the window's launches (or
    none; then the window is profiled again), and some add records of no
    duration, which halved a mean (the state entry's second pass read
    0.0140 ms in one smoke, 0.0292 in every fresh window).  If `tries`
    windows in a row record no kernel of the class (one smoke saw three
    empty windows in a row for the first attention kernel), the time is
    `held_stream_ms`'s, and a `device-ms-fallback` record says so."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dimsum_torch.profile_forward import kernel_class

    fn()
    torch.cuda.synchronize()
    windows = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        durations = {}
        n_cuda = 0
        for e in prof.events():
            us = e.time_range.elapsed_us()
            n_cuda += e.device_type == DeviceType.CUDA
            if (e.device_type == DeviceType.CUDA and us > 0
                    and not getattr(e, "is_user_annotation", False)
                    and cls in (None, kernel_class(e.name))):
                durations.setdefault(e.name, []).append(us)
        if durations:
            return sum(statistics.median(v) for v in durations.values()) / 1e3
        windows.append(n_cuda)
    ms = held_stream_ms(fn, iters)
    emit({"phase": "device-ms-fallback", "class": cls,
          "cuda_events_per_window": windows, "held_stream_ms": ms})
    return ms


def scan_inputs(batch, L, dim, n, r, dtype, seed):
    """Mixer-like inputs: u, z, B, C ~ N(0, 1); dt = softplus(dt_low @ dt_w
    + bias) with the Mamba dt init (bias from dt log-uniform in
    [1e-3, 0.1]); A = -(1..N) per channel; D = 1."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    dt = torch.exp(torch.rand(dim, generator=g, device=dev)
                   * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    x = dict(u=randn(batch, L, dim), dt_low=randn(batch, L, r),
             dt_w=(torch.rand(r, dim, generator=g, device=dev) * 2 - 1)
             / math.sqrt(r),
             A=-torch.arange(1, n + 1, device=dev, dtype=torch.float32)
             .repeat(dim, 1),
             B=randn(batch, L, n), C=randn(batch, L, n),
             D=torch.ones(dim, device=dev), z=randn(batch, L, dim),
             delta_bias=dt + torch.log(-torch.expm1(-dt)))
    fp32 = ("A", "D", "delta_bias")
    return {k: (v if k in fp32 else v.to(dtype)).contiguous()
            for k, v in x.items()}


def _bound(nbytes, flops, n_sfu):
    """(bound ms, "bytes" or "operations", which operations): the largest
    of the bytes over HBM bandwidth, the fp32 operations over the fp32
    peak and the transcendentals over the special-function units."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_fp32 = flops / FP32_FLOP_PER_S * 1e3
    t_sfu = n_sfu / SFU_EXP_PER_S * 1e3
    t = max(t_bytes, t_fp32, t_sfu)
    if t == t_bytes:
        return t, "bytes", None
    return t, "operations", "sfu" if t_sfu >= t_fp32 else "fp32"


def _bound_fields(bound):
    """A scan_bound / train_bounds tuple as record fields."""
    return dict(zip(("bound_ms", "bound_by", "bound_ops", "bytes", "flop",
                     "transcendentals"), bound))


def scan_bound(x):
    """Least time for one scan call: each input read once and the output
    written once, over HBM bandwidth; the fp32 operations, 2r (dt
    expansion) + 7N (per state: dt*A, exp2, du*B, two FMAs) + 12 (bias,
    softplus, du, skip, gate) per (b, t, d), over the fp32 peak; and the
    N + 3 transcendentals per (b, t, d) (an exp2 per state; exp and log in
    softplus; exp in the gate) over the special-function units.  Returns
    (ms, bound_by, which operations, bytes, flop, transcendentals)."""
    batch, L, dim = x["u"].shape
    r, n = x["dt_w"].shape[0], x["A"].shape[1]
    nbytes = sum(v.numel() * v.element_size() for v in x.values())
    nbytes += x["u"].numel() * x["u"].element_size()  # the output
    flops = batch * L * dim * (2 * r + 7 * n + 12)
    n_sfu = batch * L * dim * (n + 3)
    return (*_bound(nbytes, flops, n_sfu), nbytes, flops, n_sfu)


def phase_kernel():
    import torch

    from dimsum_torch.ops.selective_scan import (selective_scan_cuda,
                                                 selective_scan_dtlow)

    cases = [
        ("mixer-bf16", 24, 256, 1024, torch.bfloat16, False),
        ("mixer-bf16-reverse", 24, 256, 1024, torch.bfloat16, True),
        ("mixer-fp32", 24, 256, 1024, torch.float32, False),
        ("mixer-fp32-reverse", 24, 256, 1024, torch.float32, True),
        ("ragged-dim-bf16", 24, 256, 1000, torch.bfloat16, False),
        ("L1024-bf16", 24, 1024, 1024, torch.bfloat16, False),
    ]
    results = {}
    for i, (name, batch, L, dim, dtype, reverse) in enumerate(cases):
        x = scan_inputs(batch, L, dim, 16, 32, dtype, seed=100 + i)
        args = [x[k] for k in ("u", "dt_low", "dt_w", "A", "B", "C", "D")]
        kw = dict(z=x["z"], delta_bias=x["delta_bias"], delta_softplus=True)
        with torch.inference_mode():
            got = selective_scan_dtlow(*args, reverse=reverse, impl="cuda",
                                       **kw).float()
            want = selective_scan_dtlow(*args, reverse=reverse, impl="ref",
                                        **kw).float()
            torch.cuda.synchronize()
            # fp32: exp2 vs exp and summation order; bf16: one fp32 value
            # may round to neighbouring bf16 numbers (2 ulp = 2^-6)
            tol = 1e-4 if dtype == torch.float32 else 1.6e-2
            err = (got - want).abs()
            ok = bool(torch.isfinite(got).all()) and bool(
                (err <= tol + tol * want.abs()).all())
            ms = cuda_ms(lambda: selective_scan_cuda(*args, **kw), iters=20)
            dev_ms = (device_ms(lambda: selective_scan_cuda(*args, **kw),
                                "selective_scan")
                      if name in ("mixer-bf16", "L1024-bf16") else None)
            plain_ms = cuda_ms(lambda: selective_scan_dtlow(
                *args, impl="ref", **kw), iters=3, warmup=1)
        rec = {"phase": "kernel", "case": name, "shape": [batch, L, dim,
                                                          16, 32],
               "dtype": str(dtype).split(".")[-1], "reverse": reverse,
               "max_abs_err": err.max().item(),
               "max_abs_ref": want.abs().max().item(), "tol": tol,
               "ok": ok, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
               **_bound_fields(scan_bound(x))}
        emit(rec)
        if not ok:
            raise AssertionError(f"kernel disagrees with plain on {name}")
        results[name] = rec
    return results


def _mixers(model):
    from dimsum_torch.models.mamba import Mamba

    return [m for m in model.modules() if isinstance(m, Mamba)]


def phase_model():
    import torch

    from dimsum_torch.models.dim import DiM_models, build_dim, forward_with_cfg
    from dimsum_torch.ops.selective_scan import selective_scan_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = DiM_models["DiM-L/2"](img_resolution=32, num_classes=1000,
                                use_attn_every_k_layers=4,
                                dtype=torch.float32)
    model = build_dim(cfg, "cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(1)
    half = torch.randn((12, 4, 32, 32), generator=g, device="cuda")
    x = torch.cat([half, half])
    t = torch.rand(12, generator=g, device="cuda").repeat(2)
    y = torch.cat([torch.randint(0, 1000, (12,), generator=g, device="cuda"),
                   torch.full((12,), 1000, device="cuda")])
    with torch.inference_mode():
        selective_scan_cuda.launches = 0
        got = forward_with_cfg(model, x, t, y, cfg_scale=1.4)
        torch.cuda.synchronize()
        launches = selective_scan_cuda.launches
        for m in _mixers(model):
            m.scan_impl = "ref"
        want = forward_with_cfg(model, x, t, y, cfg_scale=1.4)
        torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    # fp32 scans differ by ~1e-6 relative (exp2 vs exp, sum order); 16
    # blocks of random weights amplify that, not past 1e-3 of the scale
    tol = 1e-3 * max(1.0, scale)
    rec = {"phase": "model", "model": "DiM-L/2", "rows": x.shape[0],
           "dtype": "float32", "tf32": False, "launches_per_forward":
           launches, "max_abs_err": err, "max_abs_ref": scale, "tol": tol,
           "finite": bool(torch.isfinite(got).all()),
           "n_mixers": len(_mixers(model))}
    emit(rec)
    if launches != 32 or not rec["finite"] or not err <= tol:
        raise AssertionError(f"model phase failed: {rec}")
    del model
    torch.cuda.empty_cache()


def phase_sample():
    import torch

    from dimsum_torch import bench
    from dimsum_torch.ops.selective_scan import selective_scan_cuda

    selective_scan_cuda.launches = 0
    record, samples = bench.run(batch=12, steps=STEPS, dtype="bf16",
                                cfg_scale=1.4, device="cuda", seed=0)
    torch.cuda.synchronize()
    launches = {"selective_scan_fwd": selective_scan_cuda.launches}
    finite = bool(torch.isfinite(samples).all())
    rec = {"phase": "sample", **record, "launches": launches,
           "shape": list(samples.shape), "finite": finite,
           "sample_std": samples.float().std().item()}
    emit(rec)
    # one warm-up drift call plus STEPS - 1 Euler steps, 32 mixers each
    if not finite or list(samples.shape) != [12, 4, 32, 32] \
            or launches["selective_scan_fwd"] != 32 * STEPS:
        raise AssertionError(f"sample phase failed: {rec}")
    return launches


def train_bounds(x, chunk):
    """Least time of the two training kernels on x's shapes: each input
    read once and each output written once over HBM bandwidth, the fp32
    operations over the fp32 peak, and the transcendentals over the
    special-function units (`_bound`).  Kernel 2: kernel 1's inputs, y
    (u's type), o and the states (fp32); 2r + 7N + 12 flop and N + 3
    transcendentals per (b, t, d), as kernel 1.  Kernel 3 (with its partial
    sums): u, dt_low, dt_w, A, B, C, bias, go and the states in, du, ddt
    (fp32) and dA, dB, dC out; 2r + 20N + 18 flop per (b, t, d) (replay:
    expansion, softplus, sigmoid, 5 per state; reverse step: 15 per state)
    and N + 3 transcendentals: an exp2 per state, exp and log in softplus,
    and the sigmoid's reciprocal (its exp is softplus's exp(-|x|)).  That
    kernel 3 computes each state's exp2 again in the reverse step, and the
    sigmoid's exp anew, and that kernel 2's state and main passes each
    compute every state's exp2 and hand dt over through o, are the
    kernels' own choices and not counted."""
    batch, L, dim = x["u"].shape
    r, n = x["dt_w"].shape[0], x["A"].shape[1]
    esize = x["u"].element_size()
    n_chunks = -(-L // chunk)
    big, small = batch * L * dim, batch * L * n
    common = (x["u"].numel() + x["dt_low"].numel() + x["dt_w"].numel()
              + 2 * small) * esize + x["A"].numel() * 4 + dim * 4
    states = batch * n_chunks * n * dim * 4
    fwd_bytes = (common + x["z"].numel() * esize + dim * 4  # z, D
                 + big * esize + big * 4 + states)          # y, o, states
    bwd_bytes = (common + big * 4 + states                  # go, states
                 + 2 * big * 4 + dim * n * 4 + 2 * small * 4)
    out = {}
    for name, nbytes, flops, n_sfu in (
            ("fwd_train", fwd_bytes, big * (2 * r + 7 * n + 12),
             big * (n + 3)),
            ("bwd", bwd_bytes, big * (2 * r + 20 * n + 18),
             big * (n + 3))):
        out[name] = (*_bound(nbytes, flops, n_sfu), nbytes, flops, n_sfu)
    return out


def _scaled_err(got, want):
    """Max |got - want| over max |want|, in fp32."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
            ).item()


def phase_kernel_train():
    import torch

    from dimsum_torch.ops import selective_scan as ss

    cases = [
        ("train-bf16", 16, 256, 1024, torch.bfloat16, False),
        ("train-bf16-reverse", 16, 256, 1024, torch.bfloat16, True),
        ("train-fp32", 16, 256, 1024, torch.float32, False),
        ("train-fp32-reverse", 16, 256, 1024, torch.float32, True),
        ("train-ragged-dim-bf16", 16, 256, 1000, torch.bfloat16, False),
        # the 512-px training mixer: the same tokens in 4 rows of L 1024
        ("L1024-bf16", 4, 1024, 1024, torch.bfloat16, False),
        ("L1024-fp32", 4, 1024, 1024, torch.float32, False),
        # a ragged last chunk and a ragged last group of chunks
        ("ragged-L-bf16", 4, 1000, 1024, torch.bfloat16, False),
    ]
    results = {}
    for i, (name, batch, L, dim, dtype, reverse) in enumerate(cases):
        x = scan_inputs(batch, L, dim, 16, 32, dtype, seed=200 + i)
        if reverse:  # the Function flips around the kernels
            x = {k: (v.flip(1) if v.ndim == 3 else v) for k, v in x.items()}
        args = [x[k] for k in ("u", "dt_low", "dt_w", "A", "B", "C", "D")]
        kw = dict(z=x["z"], delta_bias=x["delta_bias"], delta_softplus=True)
        g = torch.randn(x["u"].shape, device="cuda", generator=torch
                        .Generator(device="cuda").manual_seed(i)).to(dtype)
        low = dtype == torch.bfloat16
        with torch.no_grad():
            got_f = ss.selective_scan_fwd_train_cuda(*args, **kw)
            want_f = ss.selective_scan_fwd_train_ref(*args, **kw)
            bkw = dict(kw, o=want_f[1], boundaries=want_f[2], g=g)
            got_b = ss.selective_scan_bwd(*args, **bkw)
            want_b = ss.selective_scan_bwd_ref(*args, **bkw)
            torch.cuda.synchronize()
            # relative to each tensor's largest value: fp32 1e-4 (exp2
            # against exp, summation order); outputs stored in bf16 1.6e-2
            # (one rounding step either way)
            errs, ok = {}, True
            for key, a, b in zip(
                    ("y", "o", "boundaries", "du", "ddelta", "dA", "dB",
                     "dC", "dD", "dz", "dbias"), got_f + got_b,
                    want_f + want_b):
                tol = 1.6e-2 if a.dtype == torch.bfloat16 else 1e-4
                errs[key] = _scaled_err(a, b)
                ok = ok and bool(torch.isfinite(a.float()).all()) and \
                    errs[key] <= tol
            fwd_err = max((a.float() - b.float()).abs().max().item()
                          for a, b in zip(got_f, want_f))
            bwd_err = max((a.float() - b.float()).abs().max().item()
                          for a, b in zip(got_b, want_b))
            go = torch.randn(x["u"].shape, device="cuda")
            core = (*args[:6], x["delta_bias"], True, go, want_f[2])
            fwd_ms = cuda_ms(lambda: ss.selective_scan_fwd_train_cuda(
                *args, **kw), iters=20)
            fwd_plain = cuda_ms(lambda: ss.selective_scan_fwd_train_ref(
                *args, **kw), iters=3, warmup=1)
            bwd_ms = cuda_ms(lambda: ss.selective_scan_bwd_core_cuda(*core),
                             iters=20)
            bwd_plain = cuda_ms(lambda: ss.selective_scan_bwd_core_ref(
                *core), iters=3, warmup=1)
            fwd_dev = bwd_dev = None
            if name in ("train-bf16", "L1024-bf16"):
                fwd_dev = device_ms(lambda: ss.selective_scan_fwd_train_cuda(
                    *args, **kw), "selective_scan_fwd_train")
                bwd_dev = device_ms(lambda: ss.selective_scan_bwd_core_cuda(
                    *core), "selective_scan_bwd")
        bounds = train_bounds(x, ss.TRAIN_CHUNK)
        rec = {"phase": "kernel-train", "case": name,
               "shape": [batch, L, dim, 16, 32],
               "dtype": str(dtype).split(".")[-1], "reverse": reverse,
               "scaled_err": errs, "tol_fp32": 1e-4, "tol_bf16": 1.6e-2,
               "ok": ok, "low_precision_outputs": low,
               "fwd_train": {"max_abs_err": fwd_err, "ms": fwd_ms,
                             "device_ms": fwd_dev, "plain_ms": fwd_plain,
                             **_bound_fields(bounds["fwd_train"])},
               "bwd": {"max_abs_err": bwd_err, "ms": bwd_ms,
                       "device_ms": bwd_dev, "plain_ms": bwd_plain,
                       **_bound_fields(bounds["bwd"])}}
        emit(rec)
        if not ok:
            raise AssertionError(f"training kernels disagree on {name}")
        results[name] = rec
    return results


def _train_model(dtype, seed=0):
    from dimsum_torch.models.dim import DiM_models, build_dim

    cfg = DiM_models["DiM-L/2"](img_resolution=32, num_classes=1000,
                                use_attn_every_k_layers=4,
                                label_dropout=0.1, drop_path=0.1,
                                dtype=dtype)
    return build_dim(cfg, "cuda", seed=seed, train=True)


def phase_train_grad():
    import torch

    from dimsum_torch.ops import selective_scan as ss
    from dimsum_torch.transport import create_transport

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _train_model(torch.float32)
    transport = create_transport("GVP", "velocity")
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((2, 4, 32, 32), generator=g, device="cuda")
    y = torch.randint(0, 1000, (2,), generator=g, device="cuda")

    def loss_and_grads():
        gen = torch.Generator(device="cuda").manual_seed(4)  # same draws
        model.zero_grad(set_to_none=True)
        loss = transport.training_losses(
            lambda xt, t, **kw: model(xt, t, train=True, generator=gen,
                                      **kw), x, gen, {"y": y})["loss"].mean()
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {n: p.grad.clone() for n, p in
                             model.named_parameters() if p.grad is not None}

    counts = (ss.selective_scan_cuda, ss.selective_scan_fwd_train_cuda,
              ss.selective_scan_bwd_core_cuda)
    for c in counts:
        c.launches = 0
    loss, grads = loss_and_grads()
    launches = [c.launches for c in counts]
    for m in _mixers(model):
        m.scan_impl = "ref"
    want_loss, want = loss_and_grads()
    # fp32 kernels differ from the plain scan by ~1e-6 relative per call
    # (exp2 against exp, summation order); 16 blocks of random weights and
    # the backward amplify that, not past 2e-3 of each tensor's scale
    tol = 2e-3
    errs = {n: _scaled_err(grads[n], want[n]) for n in want}
    worst = max(errs, key=errs.get)
    rec = {"phase": "train-grad", "model": "DiM-L/2", "batch": 2,
           "dtype": "float32", "tf32": False, "loss": loss,
           "loss_plain": want_loss,
           "loss_rel_err": abs(loss - want_loss) / abs(want_loss),
           "n_grads": len(want), "same_grad_set": set(grads) == set(want),
           "worst_grad": worst, "worst_grad_scaled_err": errs[worst],
           "tol": tol, "launches_per_step": {
               "selective_scan_fwd": launches[0],
               "selective_scan_fwd_train": launches[1],
               "selective_scan_bwd": launches[2]}}
    emit(rec)
    if (launches != [0, 32, 32] or not rec["same_grad_set"]
            or not rec["loss_rel_err"] <= 1e-4 or not errs[worst] <= tol):
        raise AssertionError(f"train-grad phase failed: {rec}")
    del model, grads, want
    torch.cuda.empty_cache()


def _zeroed_scan_counts():
    """The three scan wrappers by name, their launch counts set to 0."""
    from dimsum_torch.ops import selective_scan as ss

    counts = {"selective_scan_fwd": ss.selective_scan_cuda,
              "selective_scan_fwd_train": ss.selective_scan_fwd_train_cuda,
              "selective_scan_bwd": ss.selective_scan_bwd_core_cuda}
    for c in counts.values():
        c.launches = 0
    return counts


def phase_train():
    import torch

    from dimsum_torch import train_bench

    counts = _zeroed_scan_counts()
    record, state = train_bench.run(batch=16, bf16=True, steps=TRAIN_STEPS,
                                    warmup=TRAIN_WARMUP, device="cuda",
                                    seed=0)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counts.items()}
    init = dict(_train_model(torch.bfloat16, seed=0).named_parameters())
    # a parameter whose last gradient is well above Adam's eps must have
    # moved (a smaller one may move by less than its rounding); one out of
    # the graph (CondMamba's cond_proj), which the step gives a zero
    # gradient, must not at weight decay 0
    moved, wrong, no_grad, ema_moved = 0, [], [], 0
    for name, p in state.model.named_parameters():
        changed = not torch.equal(p, init[name])
        moved += changed
        ema_moved += not torch.equal(state.ema_params[name], init[name])
        if not p.grad.any():
            no_grad.append(name)
            if changed:
                wrong.append(name)
        elif not changed and p.grad.abs().max().item() > 1e-6:
            wrong.append(name)
    n_steps = TRAIN_STEPS + TRAIN_WARMUP
    finite = bool(all(math.isfinite(v) for v in
                      record["loss"] + record["grad_norm"]))
    rec = {"phase": "train", **record, "launches": launches,
           "params_moved": moved, "ema_moved": ema_moved,
           "n_param_tensors": len(init), "without_grad": len(no_grad),
           "wrong": wrong, "finite": finite}
    emit(rec)
    if (not finite or launches["selective_scan_fwd"] != 0
            or launches["selective_scan_fwd_train"] != 32 * n_steps
            or launches["selective_scan_bwd"] != 32 * n_steps
            or wrong or len(no_grad) != 64
            or not all("cond_proj" in n for n in no_grad)
            or ema_moved < moved):
        raise AssertionError(f"train phase failed: {rec}")
    del state, init
    torch.cuda.empty_cache()
    return {k: launches[k] for k in ("selective_scan_fwd_train",
                                     "selective_scan_bwd")}


def phase_train_512():
    """The 512-px training path: `train_bench.run` at image_size 512 (L
    1024, batch 4, bf16 over fp32 weights), TRAIN_512_STEPS timed steps
    after one of warm-up.  Counts set to 0 just before and read just after:
    32 launches per step of kernels 2 and 3, none of kernel 1; finite
    losses and grad norms."""
    import torch

    from dimsum_torch import train_bench

    counts = _zeroed_scan_counts()
    record, state = train_bench.run(batch=4, bf16=True,
                                    steps=TRAIN_512_STEPS, warmup=1,
                                    device="cuda", seed=0, image_size=512)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counts.items()}
    n_steps = TRAIN_512_STEPS + 1
    finite = bool(all(math.isfinite(v) for v in
                      record["loss"] + record["grad_norm"]))
    rec = {"phase": "train-512", **record, "launches": launches,
           "finite": finite}
    emit(rec)
    if (not finite or launches["selective_scan_fwd"] != 0
            or launches["selective_scan_fwd_train"] != 32 * n_steps
            or launches["selective_scan_bwd"] != 32 * n_steps):
        raise AssertionError(f"train-512 phase failed: {rec}")
    del state
    torch.cuda.empty_cache()


def attn_bound(B, L, H, Dh, dtype):
    """Least time for one full-block attention call: q, k, v read once and
    o written once over HBM bandwidth; 4 L^2 Dh flop per (batch, head) (the
    two products) over the tensor-core bf16 peak, or for fp32 the lesser
    of the fp32 peak and three TF32 tensor-core products (~fp32 accuracy)
    over the TF32 peak, so that the bound reads the same work whichever
    design runs it; and the L^2 exp per (batch, head) over the
    special-function units.  The largest bounds."""
    import torch

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


def attn_inputs(B, L, H, Dh, dtype, seed, logit_scale=1.0):
    """q, k, v (B, L, H, Dh) as channel slices of one (B, L, 3 H Dh)
    N(0, 1) projection, the layout the modules give the kernel; q and k
    scaled by `logit_scale`."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((B, L, 3 * H * Dh), generator=g, device="cuda")
    qkv[..., :2 * H * Dh] *= logit_scale
    qkv = qkv.to(dtype)
    return [qkv[..., i * H * Dh:(i + 1) * H * Dh].reshape(B, L, H, Dh)
            for i in range(3)]


def _first_attention_kernel(q, k, v, scale):
    """csrc/full_attention.cu on Dh-64 inputs, which the route sends to the
    sm90 or the fp32 kernel: its body checked, and its time for comparison
    in the same run."""
    import torch

    from dimsum_torch.ops.full_attention import full_attention_first

    out = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    full_attention_first(q, k, v, out, scale)
    return out


def phase_kernel_attn():
    import torch
    import torch.nn.functional as F

    from dimsum_torch.ops import full_attention as attention_ops
    from dimsum_torch.ops.full_attention import (
        attention_kernel, full_attention_ref, full_block_attention,
        full_block_attention_cuda)

    cases = [
        ("dit-bf16", 24, 1024, 16, 64, torch.bfloat16),
        ("cross-bf16", 24, 1024, 8, 64, torch.bfloat16),
        ("dit-fp32", 24, 1024, 16, 64, torch.float32),
        ("cross-fp32", 24, 1024, 8, 64, torch.float32),
    ]
    results = {}
    for i, (name, B, L, H, Dh, dtype) in enumerate(cases):
        q, k, v = attn_inputs(B, L, H, Dh, dtype, seed=300 + i)
        scale = Dh ** -0.5
        kernel = attention_kernel(dtype, Dh)
        counter = getattr(attention_ops, kernel)
        # relative to the output's largest value: fp32 2e-5 (the same fp32
        # products summed in other orders, exp2 against exp); bf16 1.6e-2
        # (P rounded to bf16 against the running row max in the kernel, the
        # final one in the plain version; bf16 output)
        tol = 2e-5 if dtype == torch.float32 else 1.6e-2
        with torch.inference_mode():
            before = counter.launches
            got = full_block_attention_cuda(q, k, v, scale).float()
            took_route = counter.launches - before == 1
            want = full_attention_ref(q, k, v, scale).float()
            torch.cuda.synchronize()
            scale_ref = want.abs().max().item()
            err = (got - want).abs().max().item()
            ok = (bool(torch.isfinite(got).all())
                  and err <= tol * scale_ref and took_route)
            ms = cuda_ms(lambda: full_block_attention_cuda(q, k, v, scale),
                         iters=50)
            dev_ms = device_ms(
                lambda: full_block_attention_cuda(q, k, v, scale),
                "full_block_attention")
            plain_ms = cuda_ms(lambda: full_attention_ref(q, k, v, scale),
                               iters=3, warmup=1)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt),
                iters=50)
            library_dev_ms = device_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt), None)
            # the first kernel (csrc/full_attention.cu), which Dh 72-128
            # still takes, held to the same tolerance and timed on the
            # same inputs
            s = torch.tensor(scale, dtype=dtype).item()
            got_first = _first_attention_kernel(q, k, v, s).float()
            torch.cuda.synchronize()
            first_err = (got_first - want).abs().max().item()
            ok = ok and first_err <= tol * scale_ref
            first = {"max_abs_err": first_err, "ms": cuda_ms(
                lambda: _first_attention_kernel(q, k, v, s), iters=10),
                "device_ms": device_ms(
                    lambda: _first_attention_kernel(q, k, v, s),
                    "full_block_attention", iters=5)}
            del got_first
        bound_ms, bound_by, nbytes, flops, n_exp = attn_bound(B, L, H, Dh,
                                                              dtype)
        rec = {"phase": "kernel-attn", "case": name, "shape": [B, L, H, Dh],
               "dtype": str(dtype).split(".")[-1], "kernel": kernel,
               "max_abs_err": err, "max_abs_ref": scale_ref, "tol_rel": tol,
               "ok": ok, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "library_device_ms": library_dev_ms,
               "bound_ms": bound_ms,
               "bound_by": bound_by, "bytes": nbytes, "flop": flops,
               "exp": n_exp, "tflop_per_s": flops / ms / 1e9,
               "first_kernel": first}
        emit(rec)
        if not ok:
            raise AssertionError(f"attention kernel disagrees on {name}")
        results[name] = rec
        del q, k, v, got, want
        torch.cuda.empty_cache()

    # logits of order 1e3 (q and k 40x N(0, 1)) at the DiT shape: the
    # softmax near one-hot, where a row's two largest logits may nearly tie
    for i, dtype in enumerate((torch.float32, torch.bfloat16)):
        q, k, v = attn_inputs(24, 1024, 16, 64, dtype, seed=320 + i,
                              logit_scale=40.0)
        tol = 2e-5 if dtype == torch.float32 else 1.6e-2
        with torch.inference_mode():
            got = full_block_attention_cuda(q, k, v, 0.125).float()
            want = full_attention_ref(q, k, v, 0.125).float()
            torch.cuda.synchronize()
        scale_ref = want.abs().max().item()
        err = (got - want).abs().max().item()
        rec = {"phase": "kernel-attn", "case": f"dit-{dtype}-logits40"
               .replace("torch.", ""), "shape": [24, 1024, 16, 64],
               "kernel": attention_kernel(dtype, 64), "max_abs_err": err,
               "max_abs_ref": scale_ref, "tol_rel": tol}
        emit(rec)
        if not (bool(torch.isfinite(got).all()) and err <= tol * scale_ref):
            raise AssertionError(f"attention kernel disagrees: {rec}")
        del q, k, v, got, want
        torch.cuda.empty_cache()

    # the Function: kernel forward, backward recomputed through the plain
    # version; against autograd through the plain version alone
    grad = {}
    for dtype in (torch.float32, torch.bfloat16):
        leaves = [x.detach().requires_grad_(True) for x in
                  attn_inputs(2, 256, 2, 64, dtype, seed=310)]
        g = torch.randn(leaves[0].shape, device="cuda", generator=torch
                        .Generator(device="cuda").manual_seed(311)).to(dtype)
        before = full_block_attention_cuda.launches
        got = torch.autograd.grad(full_block_attention(*leaves, 0.125),
                                  leaves, g)
        launched = full_block_attention_cuda.launches - before
        want = torch.autograd.grad(full_attention_ref(*leaves, 0.125),
                                   leaves, g)
        torch.cuda.synchronize()
        tol = 2e-5 if dtype == torch.float32 else 1.6e-2
        errs = [_scaled_err(a, b) for a, b in zip(got, want)]
        grad[str(dtype).split(".")[-1]] = {"scaled_err": errs, "tol": tol,
                                           "launches": launched}
        if launched != 1 or not max(errs) <= tol:
            raise AssertionError(f"attention gradient disagrees: {grad}")
    emit({"phase": "kernel-attn", "case": "grad", "shape": [2, 256, 2, 64],
          **grad})
    return results


def _attention_modules(model):
    from dimsum_torch.models.attention import Attention, CrossAttentionFusion

    return [m for m in model.modules()
            if isinstance(m, (Attention, CrossAttentionFusion))]


ATTENTION_KERNELS = ("full_attention_sm90", "full_attention_f32",
                     "full_attention_first")


def _zeroed_attention_counts():
    """The scan kernel's, the attention route's and each attention
    kernel's launch counters, set to 0."""
    from dimsum_torch.ops import full_attention as attention_ops
    from dimsum_torch.ops.selective_scan import selective_scan_cuda

    counts = {"selective_scan_fwd": selective_scan_cuda,
              "full_block_attention": attention_ops.full_block_attention_cuda,
              **{n: getattr(attention_ops, n) for n in ATTENTION_KERNELS}}
    for c in counts.values():
        c.launches = 0
    return counts


def _attention_launches(calls, kernel, scan=32):
    """What `_zeroed_attention_counts` reads after `calls` drift calls of
    the 512-px model: `scan` scan and 36 attention launches each, all
    through the attention kernel `kernel`."""
    return {"selective_scan_fwd": scan * calls,
            "full_block_attention": 36 * calls,
            **{n: 36 * calls * (n == kernel) for n in ATTENTION_KERNELS}}


def phase_model_512():
    import torch

    from dimsum_torch.models.dim import DiM_models, build_dim, forward_with_cfg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = DiM_models["DiM-L/2"](img_resolution=64, num_classes=1000,
                                use_attn_every_k_layers=4,
                                dtype=torch.float32)
    model = build_dim(cfg, "cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(2)
    half = torch.randn((2, 4, 64, 64), generator=g, device="cuda")
    x = torch.cat([half, half])
    t = torch.rand(2, generator=g, device="cuda").repeat(2)
    y = torch.cat([torch.randint(0, 1000, (2,), generator=g, device="cuda"),
                   torch.full((2,), 1000, device="cuda")])
    with torch.inference_mode():
        counts = _zeroed_attention_counts()
        got = forward_with_cfg(model, x, t, y, cfg_scale=1.4)
        torch.cuda.synchronize()
        # fp32: every call through the fp32 kernel
        launches = {k: c.launches for k, c in counts.items()}
        for m in _mixers(model):
            m.scan_impl = "ref"
        for m in _attention_modules(model):
            m.attn_impl = "ref"
        want = forward_with_cfg(model, x, t, y, cfg_scale=1.4)
        torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    # fp32 kernels differ from the plain versions by ~1e-6 relative (exp2
    # against exp, summation order); 16 blocks of random weights amplify
    # that, not past 1e-3 of the scale
    tol = 1e-3 * max(1.0, scale)
    rec = {"phase": "model-512", "model": "DiM-L/2", "image_size": 512,
           "tokens": cfg.num_patches, "rows": x.shape[0], "dtype": "float32",
           "tf32": False, "launches_per_forward": launches,
           "max_abs_err": err, "max_abs_ref": scale, "tol": tol,
           "finite": bool(torch.isfinite(got).all()),
           "shape": list(got.shape)}
    emit(rec)
    if (launches != _attention_launches(1, "full_attention_f32")
            or not rec["finite"] or not err <= tol
            or rec["shape"] != [4, 4, 64, 64]):
        raise AssertionError(f"model-512 phase failed: {rec}")
    del model
    torch.cuda.empty_cache()


def _attention_without_rescale(q, k, v, sm_scale):
    """A faulty full-block attention, a control for model-512-bf16's
    tolerance: each 64-key tile's P taken against that tile's own row max
    and the tiles added without the rescale an online softmax owes them."""
    import torch

    qs = q * torch.tensor(sm_scale, dtype=q.dtype, device=q.device)
    qt, kt, vt = (t.transpose(1, 2).float() for t in (qs, k, v))
    s = torch.matmul(qt, kt.transpose(-1, -2)).unflatten(-1, (-1, 64))
    p = torch.exp(s - s.amax(-1, keepdim=True)).flatten(-2)
    o = torch.matmul(p.to(v.dtype).float(), vt) / p.sum(-1, keepdim=True)
    return o.to(q.dtype).transpose(1, 2)


def _attention_last_tile_dropped(q, k, v, sm_scale):
    """The other control: the plain attention over all keys but the last
    64, what a key loop that stops one tile short computes."""
    from dimsum_torch.ops.full_attention import full_attention_ref

    return full_attention_ref(q, k[:, :-64], v[:, :-64], sm_scale)


# model-512-bf16's limits, relative to the largest value of what they
# compare, from the phase's readings on an H100 (PERF.md section 6).  The
# seeded weights give near-uniform attention (logit spread 0.38), where a
# faulty attention reads no worse than bf16 rounding (end to end 0.0092
# against 0.0086 sound); the q and k projections are therefore scaled by
# QK_GAIN 4 (spread 6.1, peaked as a trained model's).  There: end to end,
# sound 0.0082-0.0112 and the faulty attentions at least 0.054; per call
# (each of the 36 calls, kernel against plain version on the inputs the
# model gave it), sound at most 0.0074 and faulty at least 0.34.
MODEL_512_BF16_TOL = 2.5e-2
MODEL_512_BF16_CALL_TOL = 1.6e-2  # the kernel tolerance
MODEL_512_BF16_SEEDS = (2, 3, 4)
MODEL_512_BF16_QK_GAIN = 4.0


def _sharpen_attention(model, gain):
    """Multiply the q and k projections of every attention module by `gain`
    (a power of two, exact in bf16): its logits by gain^2."""
    import torch

    from dimsum_torch.models.attention import Attention

    with torch.no_grad():
        for m in _attention_modules(model):
            lins = [m.qkv] if isinstance(m, Attention) else [m.qkv1, m.qkv2]
            for lin in lins:
                rows = 2 * lin.weight.shape[0] // 3
                lin.weight[:rows] *= gain
                if lin.bias is not None:
                    lin.bias[:rows] *= gain


def phase_model_512_bf16(qk_gain=MODEL_512_BF16_QK_GAIN):
    """The bf16 512-px CFG forward, the sampling path's own dtype, through
    the sm90 attention kernel and through the plain attention; the scan
    kernel runs on both sides, so only the attention differs.  Three seeds
    of inputs, the attention sharpened by `qk_gain`.  In the kernel's
    forward each attention call is also held against the plain version on
    the strided q, k, v the model gave it, and two faulty attentions on the
    same inputs and through the whole forward show that both limits catch
    them."""
    import torch

    from dimsum_torch.models import attention
    from dimsum_torch.models.dim import DiM_models, build_dim, forward_with_cfg
    from dimsum_torch.ops.full_attention import full_attention_ref

    cfg = DiM_models["DiM-L/2"](img_resolution=64, num_classes=1000,
                                use_attn_every_k_layers=4,
                                dtype=torch.bfloat16)
    model = build_dim(cfg, "cuda", seed=0)
    _sharpen_attention(model, qk_gain)
    kernel_attention = attention.full_block_attention
    controls = {"no_rescale": _attention_without_rescale,
                "last_tile_dropped": _attention_last_tile_dropped}

    def rel_err(got, want):
        return (got.float() - want).abs().max() / want.abs().max()

    calls = []

    def checked_attention(q, k, v, sm_scale):
        out = kernel_attention(q, k, v, sm_scale)
        want = full_attention_ref(q, k, v, sm_scale).float()
        logits = torch.einsum("lhd,mhd->hlm", q[0].float(), k[0].float())
        calls.append(torch.stack(
            [rel_err(out, want)] + [rel_err(fn(q, k, v, sm_scale), want)
                                    for fn in controls.values()]
            + [(logits * sm_scale).std()]))
        return out

    def forward_through(fn, x, t, y):
        attention.full_block_attention = fn
        try:
            return forward_with_cfg(model, x, t, y, cfg_scale=1.4).float()
        finally:
            attention.full_block_attention = kernel_attention

    readings, finite, shape = [], True, None
    with torch.inference_mode():
        for seed in MODEL_512_BF16_SEEDS:
            g = torch.Generator(device="cuda").manual_seed(seed)
            half = torch.randn((2, 4, 64, 64), generator=g, device="cuda")
            x = torch.cat([half, half])
            t = torch.rand(2, generator=g, device="cuda").repeat(2)
            y = torch.cat([
                torch.randint(0, 1000, (2,), generator=g, device="cuda"),
                torch.full((2,), 1000, device="cuda")])
            calls.clear()
            counters = _zeroed_attention_counts()
            got = forward_through(checked_attention, x, t, y)
            torch.cuda.synchronize()
            counts = {k: c.launches for k, c in counters.items()}
            # over the calls: (kernel, faulty..., logit spread) columns
            call_max = torch.stack(calls).amax(0).tolist()
            call_min = torch.stack(calls).amin(0).tolist()
            finite = finite and bool(torch.isfinite(got).all())
            shape = list(got.shape)
            want = forward_through(full_attention_ref, x, t, y)
            scale = want.abs().max().item()
            reading = {"seed": seed, "launches": counts, "max_abs_ref": scale,
                       "calls": len(calls),
                       "rel_err": (got - want).abs().max().item() / scale,
                       "call_max_rel_err": call_max[0],
                       # how peaked the attention is: the spread of the
                       # first row's logits, the largest over the calls
                       "call_max_logit_std": call_max[-1]}
            for i, name in enumerate(controls):
                bad = forward_through(controls[name], x, t, y)
                reading[f"{name}_rel_err"] = \
                    (bad - want).abs().max().item() / scale
                reading[f"call_{name}_least_rel_err"] = call_min[1 + i]
            readings.append(reading)
    worst = max(r["rel_err"] for r in readings)
    control = min(r[f"{name}_rel_err"] for r in readings for name in controls)
    call_worst = max(r["call_max_rel_err"] for r in readings)
    call_control = min(r[f"call_{name}_least_rel_err"] for r in readings
                       for name in controls)
    rec = {"phase": "model-512-bf16", "model": "DiM-L/2", "image_size": 512,
           "tokens": cfg.num_patches, "rows": 4, "dtype": "bfloat16",
           "qk_gain": qk_gain, "readings": readings, "max_rel_err": worst,
           "least_control_rel_err": control, "tol_rel": MODEL_512_BF16_TOL,
           "call_max_rel_err": call_worst,
           "call_least_control_rel_err": call_control,
           "call_tol_rel": MODEL_512_BF16_CALL_TOL, "finite": finite,
           "shape": shape}
    emit(rec)
    if (any(r["launches"] != _attention_launches(1, "full_attention_sm90")
            or r["calls"] != 36 for r in readings)
            or not finite or not worst <= MODEL_512_BF16_TOL
            or not control > MODEL_512_BF16_TOL
            or not call_worst <= MODEL_512_BF16_CALL_TOL
            or not call_control > MODEL_512_BF16_CALL_TOL
            or shape != [4, 4, 64, 64]):
        raise AssertionError(f"model-512-bf16 phase failed: {rec}")
    del model
    torch.cuda.empty_cache()


def phase_sample_512():
    import torch

    from dimsum_torch import bench

    counts = _zeroed_attention_counts()
    record, samples = bench.run(batch=12, steps=STEPS, dtype="bf16",
                                cfg_scale=1.4, device="cuda", seed=0,
                                image_size=512)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counts.items()}
    finite = bool(torch.isfinite(samples).all())
    rec = {"phase": "sample-512", **record, "launches": launches,
           "shape": list(samples.shape), "finite": finite,
           "sample_std": samples.float().std().item()}
    emit(rec)
    # one warm-up drift call plus STEPS - 1 Euler steps
    if (not finite or list(samples.shape) != [12, 4, 64, 64]
            or launches != _attention_launches(STEPS, "full_attention_sm90")):
        raise AssertionError(f"sample-512 phase failed: {rec}")
    return launches


def state_bound(x, h0: bool, last: bool):
    """Least time for one call of the state entry: as `scan_bound`, with
    the full delta read in place of dt_low and dt_w (no 2r expansion
    flops), and h0 read and the last state written, fp32 (batch, dim, N),
    where the call takes them."""
    batch, L, dim = x["u"].shape
    n = x["A"].shape[1]
    nbytes = sum(v.numel() * v.element_size() for v in x.values())
    nbytes += x["u"].numel() * x["u"].element_size()  # the output
    nbytes += (int(h0) + int(last)) * batch * dim * n * 4
    flops = batch * L * dim * (7 * n + 12)
    n_sfu = batch * L * dim * (n + 3)
    return (*_bound(nbytes, flops, n_sfu), nbytes, flops, n_sfu)


def state_inputs(batch, L, dim, n, dtype, seed):
    """`scan_inputs` with the full delta = dt_low @ dt_w in `dtype`, as
    the sequence-parallel mixer makes it, and an fp32 h0 (batch, dim, n)."""
    import torch

    x = scan_inputs(batch, L, dim, n, 32, dtype, seed)
    x["delta"] = (x.pop("dt_low") @ x.pop("dt_w")).contiguous()
    h0 = torch.randn((batch, dim, n), device="cuda", generator=torch
                     .Generator(device="cuda").manual_seed(seed + 1))
    return x, h0


def phase_kernel_state():
    import torch

    from dimsum_torch.ops.selective_scan import (selective_scan_state,
                                                 selective_scan_state_cuda)

    cases = [
        ("sp-bf16", 8, 256, 1024, torch.bfloat16),
        ("sp-fp32", 8, 256, 1024, torch.float32),
        ("ragged-bf16", 8, 250, 1000, torch.bfloat16),
    ]
    results = {}
    for i, (name, batch, L, dim, dtype) in enumerate(cases):
        x, h0 = state_inputs(batch, L, dim, 16, dtype, seed=700 + 2 * i)
        args = [x[k] for k in ("u", "delta", "A", "B", "C", "D")]
        kw = dict(z=x["z"], delta_bias=x["delta_bias"], delta_softplus=True)
        # the first SP pass (the port of _scan_kernel_with_state): zero
        # state in, the last state out; the second: seeded from h0
        first = dict(kw, return_last_state=True)
        second = dict(kw, h0=h0)
        with torch.inference_mode():
            y1, last = selective_scan_state_cuda(*args, **first)
            y2 = selective_scan_state_cuda(*args, **second)
            w1, w_last = selective_scan_state(*args, impl="ref", **first)
            w2 = selective_scan_state(*args, impl="ref", **second)
            torch.cuda.synchronize()
            # the outputs as phase kernel's; the fp32 last state, never
            # rounded to bf16, to 1e-4 of its scale in both dtypes
            tol = 1e-4 if dtype == torch.float32 else 1.6e-2
            errs = [(a.float() - b.float()).abs() for a, b in
                    ((y1, w1), (y2, w2))]
            ok = all(bool(torch.isfinite(a).all()) and bool(
                (e <= tol + tol * b.float().abs()).all())
                for a, b, e in ((y1, w1, errs[0]), (y2, w2, errs[1])))
            state_err = _scaled_err(last, w_last)
            ok = ok and state_err <= 1e-4
            main = name != "ragged-bf16"
            ms = cuda_ms(lambda: selective_scan_state_cuda(*args, **first),
                         iters=50)
            h0_ms = cuda_ms(lambda: selective_scan_state_cuda(
                *args, **second), iters=50)
            dev_ms = (device_ms(lambda: selective_scan_state_cuda(
                *args, **first), "selective_scan") if main else None)
            h0_dev_ms = (device_ms(lambda: selective_scan_state_cuda(
                *args, **second), "selective_scan") if main else None)
            plain_ms = cuda_ms(lambda: selective_scan_state(
                *args, impl="ref", **first), iters=3, warmup=1)
        bound = state_bound(x, h0=False, last=True)
        rec = {"phase": "kernel-state", "case": name,
               "shape": [batch, L, dim, 16], "dtype": str(dtype).split(".")[-1],
               "max_abs_err": max(e.max().item() for e in errs),
               "max_abs_ref": max(w1.abs().max().item(),
                                  w2.abs().max().item()),
               "tol": tol, "last_state_scaled_err": state_err,
               "last_state_tol": 1e-4, "ok": ok, "ms": ms,
               "device_ms": dev_ms, "plain_ms": plain_ms,
               **_bound_fields(bound), "h0_ms": h0_ms,
               "h0_device_ms": h0_dev_ms,
               "h0_bound_ms": state_bound(x, h0=True, last=False)[0]}
        emit(rec)
        if not ok:
            raise AssertionError(f"state kernel disagrees with plain on "
                                 f"{name}: {rec}")
        results[name] = rec
    return results


# sample-sp-512: ranks on the one card (gloo: NCCL refuses two ranks on
# one device), images (CFG rows 2x), Euler grid points, seconds for the
# process group's collectives and for the whole group of ranks
SP_RANKS, SP_BATCH, SP_STEPS = 4, 4, 4
SP_TIMEOUT, SP_DEADLINE = 300, 480
# scaled errors against the unsharded model on the card.  fp32: only the
# order of the scan's fp32 sums differs (the two-level fold across shards;
# phase model's 16 random blocks amplify ~1e-6 to not past 1e-3, and here
# the fold alone moves ~1e-7).  bf16 (a few Euler steps): the SP mixer
# materializes dt = dt_low @ dt_w in bf16, as the JAX package does
# (mamba.py:252), where the unsharded kernel expands it in fp32; on the
# small DiM that rounding moves the forward 1.5e-2 of scale against a 5e-2
# limit (tests/test_torch_dim.py::test_bf16_dim_forward_tracks_jax).
SP_512_FP32_TOL, SP_512_BF16_TOL = 1e-4, 5e-2


def _sp_counts(zero: bool = False):
    from dimsum_torch.ops import full_attention as attention_ops
    from dimsum_torch.ops.selective_scan import (selective_scan_cuda,
                                                 selective_scan_state_cuda)

    fns = {"selective_scan_fwd_state": selective_scan_state_cuda,
           "selective_scan_fwd": selective_scan_cuda,
           "full_block_attention": attention_ops.full_block_attention_cuda,
           **{n: getattr(attention_ops, n) for n in ATTENTION_KERNELS}}
    if zero:
        for fn in fns.values():
            fn.launches = 0
    return {k: fn.launches for k, fn in fns.items()}


def _sp_rank(rank, k, port, out_dir):
    """One rank of sample-sp-512 (a process of its own on the one card);
    writes its record to out_dir/rank<rank>.json."""
    import datetime
    import os

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=k,
        rank=rank, timeout=datetime.timedelta(seconds=SP_TIMEOUT))
    try:
        rec = _sp_rank_run(rank, k)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def _sp_rank_run(rank, k):
    import torch
    import torch.distributed as dist

    from dimsum_torch.models.dim import DiM_models, build_dim, forward_with_cfg
    from dimsum_torch.models.mamba import Mamba
    from dimsum_torch.parallel import make_seq_group
    from dimsum_torch.transport import Sampler, create_transport

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = make_seq_group(1, k).seq

    # every all_gather of this rank counted; with `timed` set, timed from
    # a synchronized device to the gathered result on it, by kind: a mixer
    # gathers the conv's halos, the scan's summaries and its output, in
    # that order
    kinds = ("halos", "summaries", "outputs")
    gathers = {"calls": 0, "timed": False,
               "seconds": dict.fromkeys(kinds, 0.0)}
    real = dist.all_gather

    def counted(parts, x, group=None):
        kind = kinds[gathers["calls"] % 3]
        gathers["calls"] += 1
        if not gathers["timed"]:
            return real(parts, x, group=group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(parts, x, group=group)
        torch.cuda.synchronize()
        gathers["seconds"][kind] += time.perf_counter() - t0
        return out

    dist.all_gather = counted

    def model_for(dtype):
        # the seeded weights of sample-512 (bench.run at image_size 512)
        cfg = DiM_models["DiM-L/2"](img_resolution=64, num_classes=1000,
                                    use_attn_every_k_layers=4, dtype=dtype,
                                    seq_group=group)
        return build_dim(cfg, "cuda", seed=0)

    def sharded(model, on):
        for m in model.modules():
            if isinstance(m, Mamba):
                m.seq_group = group if on else None

    g = torch.Generator(device="cuda").manual_seed(0)
    half = torch.randn((SP_BATCH, 4, 64, 64), generator=g, device="cuda")
    z = torch.cat([half, half])
    y = torch.cat([
        torch.randint(0, 1000, (SP_BATCH,), generator=g, device="cuda"),
        torch.full((SP_BATCH,), 1000, device="cuda")])
    t = torch.rand(SP_BATCH, generator=g, device="cuda").repeat(2)
    rec = {"rank": rank}

    # (i) one fp32 CFG drift call, TF32 off, against the unsharded forward
    model = model_for(torch.float32)
    with torch.inference_mode():
        _sp_counts(zero=True)
        got = forward_with_cfg(model, z, t, y, cfg_scale=1.4)
        torch.cuda.synchronize()
        rec["fp32_launches"] = _sp_counts()
        rec["fp32_finite"] = bool(torch.isfinite(got).all())
        if rank == 0:
            sharded(model, False)
            want = forward_with_cfg(model, z, t, y, cfg_scale=1.4)
            rec["fp32_scaled_err"] = _scaled_err(got, want)
            rec["fp32_max_abs_ref"] = want.abs().max().item()
    del model, got
    torch.cuda.empty_cache()
    dist.barrier()

    # (ii) a few bf16 Euler steps with CFG 1.4 against the unsharded run
    model = model_for(torch.bfloat16)
    sampler = Sampler(create_transport("GVP", "velocity"))

    def model_fn(x, t, y=None):
        return forward_with_cfg(model, x, t, y, cfg_scale=1.4)

    def sample(steps):
        return sampler.sample_ode(sampling_method="euler",
                                  num_steps=steps)(z, model_fn, y=y)

    with torch.inference_mode():
        sample(2)  # one untimed drift call
        torch.cuda.synchronize()
        dist.barrier()
        _sp_counts(zero=True)
        t0 = time.perf_counter()
        out = sample(SP_STEPS)
        torch.cuda.synchronize()
        rec["seconds"] = time.perf_counter() - t0
        rec["launches"] = _sp_counts()
        rec["finite"] = bool(torch.isfinite(out).all())
        rec["shape"] = list(out[:SP_BATCH].shape)
        # one more drift call with every all_gather timed between
        # synchronizations: the collectives' share of a call
        calls0 = gathers["calls"]
        gathers["timed"] = True
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model_fn(z, t, y)
        torch.cuda.synchronize()
        rec["timed_call_seconds"] = time.perf_counter() - t0
        rec["gather_seconds"] = gathers["seconds"]
        rec["gathers_per_call"] = gathers["calls"] - calls0
        gathers["timed"] = False
        dist.barrier()
        if rank == 0:
            # the unsharded run, alone on the card (the other ranks wait)
            sharded(model, False)
            sample(2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = sample(SP_STEPS)
            torch.cuda.synchronize()
            rec["unsharded_seconds"] = time.perf_counter() - t0
            rec["bf16_scaled_err"] = _scaled_err(out, want)
            rec["bf16_max_abs_ref"] = want.float().abs().max().item()
    dist.barrier()
    return rec


def phase_sample_sp_512():
    """sample-sp-512: DiM-L/2 at 512 px sequence-parallel over SP_RANKS
    ranks, processes on the one card joined by gloo, every mixer's conv
    and scan split along L (256 of the 1024 tokens a rank)."""
    import os
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from dimsum_torch.ops import cuda_build

    cuda_build.build()  # here, not in each rank
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(_sp_rank, args=(SP_RANKS, port, tmp),
                                 nprocs=SP_RANKS, join=False,
                                 start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > SP_DEADLINE:
                    raise TimeoutError(f"sample-sp-512: ranks still running "
                                       f"after {SP_DEADLINE} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        group_seconds = time.perf_counter() - t0
        recs = []
        for r in range(SP_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                recs.append(json.load(f))
    calls = SP_STEPS - 1
    # the bf16 steps through the sm90 kernel, the fp32 call through the
    # fp32 kernel; every scan through the state entry
    want = {"selective_scan_fwd_state": 2 * 32 * calls,
            **_attention_launches(calls, "full_attention_sm90", scan=0)}
    want_fp32 = {"selective_scan_fwd_state": 2 * 32,
                 **_attention_launches(1, "full_attention_f32", scan=0)}
    r0 = recs[0]
    seconds = max(r["seconds"] for r in recs)
    share = {kind: max(r["gather_seconds"][kind] / r["timed_call_seconds"]
                       for r in recs) for kind in recs[0]["gather_seconds"]}
    rec = {"phase": "sample-sp-512", "model": "DiM-L/2", "image_size": 512,
           "ranks": SP_RANKS, "backend": "gloo", "batch": SP_BATCH,
           "rows": 2 * SP_BATCH, "steps": SP_STEPS, "cfg_scale": 1.4,
           "fp32_scaled_err": r0["fp32_scaled_err"],
           "fp32_tol": SP_512_FP32_TOL,
           "bf16_scaled_err": r0["bf16_scaled_err"],
           "bf16_tol": SP_512_BF16_TOL,
           "launches": [r["launches"] for r in recs],
           "fp32_launches": [r["fp32_launches"] for r in recs],
           "seconds": seconds, "seconds_per_call": seconds / calls,
           "unsharded_seconds_per_call": r0["unsharded_seconds"] / calls,
           "gathers_per_call": r0["gathers_per_call"],
           "timed_call_seconds": [r["timed_call_seconds"] for r in recs],
           "gather_share": max(sum(r["gather_seconds"].values())
                               / r["timed_call_seconds"] for r in recs),
           "gather_share_by_kind": share,
           "group_seconds": group_seconds,
           "finite": all(r["finite"] and r["fp32_finite"] for r in recs),
           "shape": r0["shape"]}
    emit(rec)
    if (not rec["finite"] or rec["shape"] != [SP_BATCH, 4, 64, 64]
            or not rec["fp32_scaled_err"] <= SP_512_FP32_TOL
            or not rec["bf16_scaled_err"] <= SP_512_BF16_TOL
            or any(r["launches"] != want for r in recs)
            or any(r["fp32_launches"] != want_fp32 for r in recs)
            or rec["gathers_per_call"] != 3 * 32):
        raise AssertionError(f"sample-sp-512 phase failed: {rec}")
    return r0["launches"]


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


# (name, has_branch, has_gate, has_res, has_mod, is_rms, has_w): the norm +
# modulate call sites of the fused-kernel configuration
NORM_SITES = (
    ("norm_2", True, True, False, True, True, True),
    ("dit-h2", True, True, False, True, False, False),
    ("dit-h1-final", False, False, False, True, False, False),
    ("deferred-top", True, True, True, False, True, True),
)


def norm_case_inputs(B, L, D, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, s=1.0):
        return s * torch.randn(shape, generator=g, device="cuda")

    v = dict(x=r(B, L, D), branch=r(B, L, D), residual=r(B, L, D),
             gate=r(B, D, s=0.5), shift=r(B, D, s=0.3), scale=r(B, D, s=0.3),
             weight=1 + r(D, s=0.1), bias=r(D, s=0.1))
    fp32 = ("residual", "weight", "bias")
    return {k: (t if k in fp32 else t.to(dtype)) for k, t in v.items()}


def _case_record(name, dtype, shape, got, want, tols, ms, plain_ms, bound):
    """One kernel case: each output's max error against the plain
    version's, within its tolerance relative to that output's largest
    value; the kernel and plain times; the bound."""
    import torch

    errs, ok = [], True
    for a, b, tol in zip(got, want, tols):
        err = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        errs.append(err)
        ok = ok and bool(torch.isfinite(a.float()).all()) and \
            err <= tol * max(scale, 1e-30)
    return {"case": name, "shape": shape,
            "dtype": str(dtype).split(".")[-1], "max_abs_err": max(errs),
            "errs_out_total": errs, "tol_rel": tols, "ok": ok, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "bytes": bound[2], "flop": bound[3]}


# the 512-px cases (L 1024) of the two sites with gate, shift and scale
NORM_SITES_L1024 = ("norm_2", "dit-h2")
# bytes written between launches for the L2-cold reading (the L2 is 50 MB)
L2_FLUSH_BYTES = 128 * 2**20


def _norm_site_record(site, v, dtype, low, flush=None):
    """One norm + modulate site on the inputs `v`: the kernel against its
    plain version, `cuda_ms`, `device_ms`, the plain time and the bound; with
    `flush` (a tensor), also `cold_device_ms`: the kernel's device time when
    `flush` is written before each launch, so that its inputs and outputs
    come from device memory and not from the L2."""
    import torch

    from dimsum_torch.ops.norms import norm_modulate_cuda, norm_modulate_ref

    name, br, gt, res, mod, rms, w = site
    B, L, D = v["x"].shape
    esize = v["x"].element_size()
    kw = dict(weight=v["weight"] if w else None,
              bias=v["bias"] if w and not rms else None,
              branch=v["branch"] if br else None,
              gate=v["gate"] if gt else None,
              residual=v["residual"] if res else None,
              shift=v["shift"] if mod else None,
              scale=v["scale"] if mod else None,
              eps=1e-5 if rms else 1e-6, is_rms=rms,
              total_dtype=torch.float32 if res else None)
    with torch.inference_mode():
        got = norm_modulate_cuda(v["x"], **kw)
        want = norm_modulate_ref(v["x"], **kw)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: norm_modulate_cuda(v["x"], **kw), iters=20)
        dev_ms = device_ms(lambda: norm_modulate_cuda(v["x"], **kw),
                           "norm_modulate")
        cold_ms = None if flush is None else device_ms(
            lambda: (flush.add_(1), norm_modulate_cuda(v["x"], **kw)),
            "norm_modulate")
        plain_ms = cuda_ms(lambda: norm_modulate_ref(v["x"], **kw), iters=5)
    tot_size = 4 if res else esize
    bound = norm_bound(B * L * D, B, D, esize, dict(
        branch=esize * br, gate=esize * gt, res=4 * res,
        shift=esize * mod, scale=esize * mod, w=4 * w,
        b=4 * (w and not rms), total=tot_size, rms=rms))
    rec = _case_record(name, dtype, [B, L, D], got, want,
                       (low, 1e-5 if res else low), ms, plain_ms, bound)
    rec["device_ms"] = dev_ms
    if flush is not None:
        rec["cold_device_ms"] = cold_ms
    emit({"phase": "kernel-norm", "kernel": "norm_modulate", **rec})
    if not rec["ok"]:
        raise AssertionError(f"norm_modulate kernel disagrees: {rec}")
    return rec


def phase_kernel_norm():
    import torch

    from dimsum_torch.ops.norms import add_norm_cuda, add_norm_ref

    B, L, D = 24, 256, 1024
    results = {"add_norm": {}, "norm_modulate": {}}
    flush = torch.zeros(L2_FLUSH_BYTES // 4, device="cuda")
    for i, dtype in enumerate((torch.bfloat16, torch.float32)):
        esize = torch.tensor([], dtype=dtype).element_size()
        # relative to each output's largest value: fp32 1e-5 (rsqrt and
        # summation order); stored in bf16 1.6e-2 (one rounding step)
        low = 1.6e-2 if dtype == torch.bfloat16 else 1e-5
        v = norm_case_inputs(B, L, D, dtype, seed=400 + i)
        x2 = v["x"].reshape(-1, D)
        r2 = v["residual"].reshape(-1, D)
        with torch.inference_mode():
            args = (x2, r2, v["weight"], None, 1e-5, True)
            got = add_norm_cuda(*args)
            want = add_norm_ref(*args, dtype)
            torch.cuda.synchronize()
            ms = cuda_ms(lambda: add_norm_cuda(*args), iters=20)
            dev_ms = device_ms(lambda: add_norm_cuda(*args), "add_norm")
            plain_ms = cuda_ms(lambda: add_norm_ref(*args, dtype), iters=5)
        bound = norm_bound(B * L * D, B, D, esize,
                           dict(res=4, total=4, w=4, rms=True))
        rec = _case_record("add_norm", dtype, [B, L, D], got, want,
                           (low, 1e-5), ms, plain_ms, bound)
        rec["device_ms"] = dev_ms
        emit({"phase": "kernel-norm", "kernel": "add_norm", **rec})
        if not rec["ok"]:
            raise AssertionError(f"add_norm kernel disagrees: {rec}")
        results["add_norm"][rec["dtype"]] = rec

        for site in NORM_SITES:
            # the main case (norm_2, bf16) also read with a cold L2
            cold = flush if site[0] == "norm_2" and i == 0 else None
            rec = _norm_site_record(site, v, dtype, low, cold)
            results["norm_modulate"][f"{site[0]}-{rec['dtype']}"] = rec
        del v, x2, r2
        torch.cuda.empty_cache()
    # the 512-px shape, bf16: the inputs (100 MB at norm_2) exceed the L2
    v = norm_case_inputs(B, 4 * L, D, torch.bfloat16, seed=402)
    for site in NORM_SITES:
        if site[0] in NORM_SITES_L1024:
            rec = _norm_site_record(site, v, torch.bfloat16, 1.6e-2)
            results["norm_modulate"][f"{site[0]}-L1024-bfloat16"] = rec
    del v, flush
    torch.cuda.empty_cache()
    return results


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


def phase_kernel_convx():
    import torch

    from dimsum_torch.ops.conv_xproj import conv_xproj_cuda, conv_xproj_ref

    cases = [
        ("mixer-bf16", 24, 256, 1024, 64, torch.bfloat16, False),
        ("mixer-bf16-reverse", 24, 256, 1024, 64, torch.bfloat16, True),
        ("mixer-fp32", 24, 256, 1024, 64, torch.float32, False),
        ("mixer-fp32-reverse", 24, 256, 1024, 64, torch.float32, True),
        ("L1024-bf16", 24, 1024, 1024, 64, torch.bfloat16, False),
        ("xl-R68-bf16", 24, 256, 1152, 68, torch.bfloat16, False),
        # ragged L (one token past four 16-token units, and 127); the
        # gate's widest R
        ("ragged-L65-bf16", 24, 65, 1024, 64, torch.bfloat16, False),
        ("ragged-L127-bf16-reverse", 24, 127, 1024, 64, torch.bfloat16, True),
        ("R512-bf16", 24, 256, 1024, 512, torch.bfloat16, False),
    ]
    results = {}
    for i, (name, B, L, D, R, dtype, reverse) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(500 + i)
        # x_in as the mixer gets it: the first half of in_proj's output
        xz = torch.randn((B, L, 2 * D), generator=g, device="cuda").to(dtype)
        x = xz[..., :D]
        cw = 0.3 * torch.randn((D, 4), generator=g, device="cuda")
        cb = 0.1 * torch.randn(D, generator=g, device="cuda")
        w = (torch.randn((R, D), generator=g, device="cuda")
             / math.sqrt(D)).to(dtype)
        with torch.inference_mode():
            got = conv_xproj_cuda(x, cw, cb, w, reverse)
            want = conv_xproj_ref(x, cw, cb, w, reverse)
            torch.cuda.synchronize()
            ms = cuda_ms(lambda: conv_xproj_cuda(x, cw, cb, w, reverse),
                         iters=20)
            dev_ms = (device_ms(lambda: conv_xproj_cuda(x, cw, cb, w,
                                                        reverse),
                                "conv_xproj")
                      if name in ("mixer-bf16", "L1024-bf16") else None)
            plain_ms = cuda_ms(lambda: conv_xproj_ref(x, cw, cb, w, reverse),
                               iters=5)
        bf16 = dtype == torch.bfloat16
        bound = convx_bound(B, L, D, 4, R, x.element_size(),
                            BF16_TC_FLOP_PER_S if bf16 else FP32_FLOP_PER_S)
        # relative to each output's largest value: x_conv fp32 1e-5 (exp),
        # bf16 1.6e-2 (one rounding step); x_dbl fp32 1e-5 (summation
        # order), from bf16 x_conv 1e-2 (an entry rounded the other way)
        rec = _case_record(name, dtype, [B, L, D, 4, R], got, want,
                           (1.6e-2, 1e-2) if bf16 else (1e-5, 1e-5), ms,
                           plain_ms, bound)
        rec.update(reverse=reverse, device_ms=dev_ms)
        emit({"phase": "kernel-convx", **rec})
        if not rec["ok"]:
            raise AssertionError(f"conv_xproj kernel disagrees on {name}")
        results[name] = rec
        del xz, x, got, want
        torch.cuda.empty_cache()
    return results


FUSED_ON = dict(pallas_norm=True, fused_norm=True, conv_xproj=True)


def _fused_counts():
    from dimsum_torch.ops.conv_xproj import conv_xproj_cuda
    from dimsum_torch.ops.norms import add_norm_cuda, norm_modulate_cuda

    return {"add_norm": add_norm_cuda, "norm_modulate": norm_modulate_cuda,
            "conv_xproj": conv_xproj_cuda}


def _plain_fused(model):
    """Send every fused-kernel site of `model` to the kernels' plain
    versions."""
    for m in model.modules():
        if hasattr(m, "norm_impl"):
            m.norm_impl = "ref"
        if hasattr(m, "conv_impl"):
            m.conv_impl = "ref"


# launches per DiM-L/2 forward with the three switches on
FUSED_LAUNCHES = {0: {"add_norm": 15, "norm_modulate": 25, "conv_xproj": 32},
                  2: {"add_norm": 3, "norm_modulate": 37, "conv_xproj": 32}}


def phase_model_fused():
    import torch

    from dimsum_torch.models.dim import DiM_models, build_dim, forward_with_cfg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(6)
    half = torch.randn((12, 4, 32, 32), generator=g, device="cuda")
    x = torch.cat([half, half])
    t = torch.rand(12, generator=g, device="cuda").repeat(2)
    y = torch.cat([torch.randint(0, 1000, (12,), generator=g, device="cuda"),
                   torch.full((12,), 1000, device="cuda")])

    def build(**switches):
        cfg = DiM_models["DiM-L/2"](img_resolution=32, num_classes=1000,
                                    use_attn_every_k_layers=4,
                                    dtype=torch.float32, **switches)
        return build_dim(cfg, "cuda", seed=0)

    counts = _fused_counts()
    with torch.inference_mode():
        model = build()
        default = forward_with_cfg(model, x, t, y, cfg_scale=1.4)
        del model
        for pending_tail in (0, 2):
            model = build(**FUSED_ON, pending_tail=pending_tail)
            for c in counts.values():
                c.launches = 0
            got = forward_with_cfg(model, x, t, y, cfg_scale=1.4)
            torch.cuda.synchronize()
            launches = {k: c.launches for k, c in counts.items()}
            _plain_fused(model)
            plain = forward_with_cfg(model, x, t, y, cfg_scale=1.4)
            torch.cuda.synchronize()
            del model
            scale = default.abs().max().item()
            # fp32 kernels and plain versions differ by ~1e-6 relative per
            # call (rsqrt, exp, summation order); 16 blocks of random
            # weights amplify that, not past 1e-3 of the scale
            tol = 1e-3 * max(1.0, scale)
            errs = {"kernels_vs_plain": (got - plain).abs().max().item(),
                    "kernels_vs_default": (got - default).abs().max().item(),
                    "plain_vs_default": (plain - default).abs().max().item()}
            rec = {"phase": "model-fused", "model": "DiM-L/2",
                   "rows": x.shape[0], "dtype": "float32", "tf32": False,
                   "switches": {**FUSED_ON, "pending_tail": pending_tail},
                   "launches_per_forward": launches, "max_abs_err": errs,
                   "max_abs_ref": scale, "tol": tol,
                   "finite": bool(torch.isfinite(got).all())}
            emit(rec)
            if (launches != FUSED_LAUNCHES[pending_tail] or not rec["finite"]
                    or not max(errs.values()) <= tol):
                raise AssertionError(f"model-fused phase failed: {rec}")
    torch.cuda.empty_cache()


def phase_train_grad_fused():
    import torch

    from dimsum_torch.models.dim import DiM_models, build_dim
    from dimsum_torch.transport import create_transport

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = DiM_models["DiM-L/2"](img_resolution=32, num_classes=1000,
                                use_attn_every_k_layers=4,
                                label_dropout=0.1, drop_path=0.1,
                                dtype=torch.float32, **FUSED_ON)
    model = build_dim(cfg, "cuda", seed=0, train=True)
    transport = create_transport("GVP", "velocity")
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((2, 4, 32, 32), generator=g, device="cuda")
    y = torch.randint(0, 1000, (2,), generator=g, device="cuda")

    def loss_and_grads():
        gen = torch.Generator(device="cuda").manual_seed(4)  # same draws
        model.zero_grad(set_to_none=True)
        loss = transport.training_losses(
            lambda xt, t, **kw: model(xt, t, train=True, generator=gen,
                                      **kw), x, gen, {"y": y})["loss"].mean()
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {n: p.grad.clone() for n, p in
                             model.named_parameters() if p.grad is not None}

    counts = _fused_counts()
    for c in counts.values():
        c.launches = 0
    loss, grads = loss_and_grads()
    launches = {k: c.launches for k, c in counts.items()}
    _plain_fused(model)
    want_loss, want = loss_and_grads()
    # as train-grad: ~1e-6 relative per call, amplified by 16 blocks and
    # the backward, not past 2e-3 of each tensor's scale
    tol = 2e-3
    errs = {n: _scaled_err(grads[n], want[n]) for n in want}
    worst = max(errs, key=errs.get)
    rec = {"phase": "train-grad-fused", "model": "DiM-L/2", "batch": 2,
           "dtype": "float32", "tf32": False, "switches": FUSED_ON,
           "loss": loss, "loss_plain": want_loss,
           "loss_rel_err": abs(loss - want_loss) / abs(want_loss),
           "n_grads": len(want), "same_grad_set": set(grads) == set(want),
           "worst_grad": worst, "worst_grad_scaled_err": errs[worst],
           "tol": tol, "launches_per_step": launches}
    emit(rec)
    if (launches != FUSED_LAUNCHES[0] or not rec["same_grad_set"]
            or not rec["loss_rel_err"] <= 1e-4 or not errs[worst] <= tol):
        raise AssertionError(f"train-grad-fused phase failed: {rec}")
    del model, grads, want
    torch.cuda.empty_cache()


def phase_sample_fused():
    import torch

    from dimsum_torch import bench

    counts = _fused_counts()
    for c in counts.values():
        c.launches = 0
    record, samples = bench.run(batch=12, steps=STEPS, dtype="bf16",
                                cfg_scale=1.4, device="cuda", seed=0,
                                **FUSED_ON)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counts.items()}
    finite = bool(torch.isfinite(samples).all())
    rec = {"phase": "sample-fused", **record, "launches": launches,
           "shape": list(samples.shape), "finite": finite,
           "sample_std": samples.float().std().item()}
    emit(rec)
    # one warm-up drift call plus STEPS - 1 Euler steps
    want = {k: n * STEPS for k, n in FUSED_LAUNCHES[0].items()}
    if not finite or list(samples.shape) != [12, 4, 32, 32] \
            or launches != want:
        raise AssertionError(f"sample-fused phase failed: {rec}")
    return launches


def phase_sample_fused_512():
    """phase_sample_fused's run at 512 px: the fused kernels and the sm90
    attention kernel together, as the fused 512-px sampling path runs."""
    import torch

    from dimsum_torch import bench

    counts = {**_fused_counts(), **_zeroed_attention_counts()}
    for c in counts.values():
        c.launches = 0
    record, samples = bench.run(batch=12, steps=STEPS, dtype="bf16",
                                cfg_scale=1.4, device="cuda", seed=0,
                                image_size=512, **FUSED_ON)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counts.items()}
    finite = bool(torch.isfinite(samples).all())
    rec = {"phase": "sample-fused-512", **record, "launches": launches,
           "shape": list(samples.shape), "finite": finite,
           "sample_std": samples.float().std().item()}
    emit(rec)
    # one warm-up drift call plus STEPS - 1 Euler steps
    want = {k: n * STEPS for k, n in FUSED_LAUNCHES[0].items()}
    want.update(_attention_launches(STEPS, "full_attention_sm90"))
    if not finite or list(samples.shape) != [12, 4, 64, 64] \
            or launches != want:
        raise AssertionError(f"sample-fused-512 phase failed: {rec}")
    return launches


# the published DiM-L/2 flags of the reference's sampling script, in bf16
DIM_L2_ARGS = ["--model", "DiM-L/2", "--num-classes", "1001",
               "--block-type", "combined", "--bimamba-type", "none",
               "--rms-norm", "--fused-add-norm", "--learnable-pe",
               "--cond-mamba", "--use-attn-every-k-layers", "4",
               "--path-type", "GVP", "--bf16"]
DOPRI5_BATCH = 4      # images of the dopri5 run (8 CFG rows)
SDE_512_STEPS = 10    # grid points of the 512-px SDE run
FP32_512_STEPS = 10   # grid points of the fp32 512-px ODE run
LIKELIHOOD_STEPS = 6  # grid points of the likelihood run


def _dim_l2_config(image_size, dtype=None):
    import torch

    from dimsum_torch.models.dim import DiM_models

    return DiM_models["DiM-L/2"](img_resolution=image_size // 8,
                                 num_classes=1001, label_dropout=0.1,
                                 use_attn_every_k_layers=4,
                                 dtype=dtype or torch.float32)


def write_checkpoints(tmp):
    """Seeded random DiM-L/2 weights (256 px) in the reference's .pt
    layout, "ema" from `random_init_` seed 0 and "model" from seed 1, and
    a full-width SD-VAE (ch 128, ch_mult 1 2 4 4) with seeded random
    weights as a diffusers state dict.  Returns (checkpoint path, its
    state dicts, VAE path)."""
    import argparse
    import os

    import torch

    from dimsum_torch.models.dim import DiM, random_init_
    from dimsum_torch.models.vae import load_vae

    with torch.device("cuda"):
        net = DiM(_dim_l2_config(256))
    sds = {}
    for key, seed in (("ema", 0), ("model", 1)):
        random_init_(net, seed)
        sds[key] = {k: v.detach().to("cpu", copy=True)
                    for k, v in net.state_dict().items()}
    path = os.path.join(tmp, "dim-l2-256.pt")
    torch.save({**sds, "args": argparse.Namespace(model="DiM-L/2")}, path)
    vae_path = os.path.join(tmp, "sd-vae.pt")
    torch.save({k: v.cpu() for k, v in
                load_vae("random:0", "cuda").state_dict().items()}, vae_path)
    del net
    torch.cuda.empty_cache()
    return path, sds, vae_path


def _sample_argv(ckpt, out, *extra):
    return ["ODE", *DIM_L2_ARGS, "--image-size", "256", "--ckpt", ckpt,
            "--sample-dir", out, *extra]


def phase_sample_dopri5(tmp, ckpt, sds, vae_path):
    """The reference's eval protocol through `python -m
    dimsum_torch.sample`: ODE dopri5 (atol 1e-6, rtol 1e-3), CFG 1.4, 256
    px, bf16, DOPRI5_BATCH images from the checkpoint's EMA weights,
    decoded by the SD-VAE into PNGs.  Counts set to 0 just before and read
    just after: 32 launches of kernel 1 per drift call, NFE + 1 calls (the
    NFE and the uncounted initial-step probe), none of kernels 2 and 3;
    one 256 x 256 PNG per image; finite latents.  Then `--params` picks the
    checkpoint's "ema" or "model" weights (one Euler step of one image
    against the same step through a model built from each seed), and a
    checkpoint with one key removed is refused."""
    import os

    import torch

    from dimsum_torch import sample
    from dimsum_torch.models.dim import build_dim, forward_with_cfg
    from dimsum_torch.transport import Sampler, create_transport
    from dimsum_torch.utils.png import read_png

    out = os.path.join(tmp, "samples")
    counts = _zeroed_scan_counts()
    rec = sample.main(_sample_argv(
        ckpt, out, "--vae-ckpt", vae_path, "--sampling-method", "dopri5",
        "--compute-nfe", "--cfg-scale", "1.4", "--global-batch-size",
        str(DOPRI5_BATCH)))
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counts.items()}
    pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    sizes = sorted({read_png(os.path.join(out, f)).shape for f in pngs})
    finite = bool(torch.isfinite(rec["samples"]).all())
    nfe = rec["nfe"]

    # --params: one Euler step of one image, through the CLI and through a
    # model built from each seed
    picked = {}
    for params, seed in (("ema", 0), ("raw", 1)):
        got = sample.main(_sample_argv(
            ckpt, os.path.join(tmp, "quick"), "--params", params,
            "--sampling-method", "euler", "--num-sampling-steps", "2",
            "--cfg-scale", "1.4", "--global-batch-size", "1"))["samples"]
        net = build_dim(_dim_l2_config(256, torch.bfloat16), "cuda", seed)
        g = torch.Generator(device="cuda").manual_seed(0)
        z = torch.randn((1, 4, 32, 32), generator=g, device="cuda")
        y = torch.randint(0, 1000, (1,), generator=g, device="cuda")
        with torch.no_grad():
            want = Sampler(create_transport("GVP", "velocity")).sample_ode(
                sampling_method="euler", num_steps=2)(
                torch.cat([z, z]), lambda x, t, y=None: forward_with_cfg(
                    net, x, t, y, cfg_scale=1.4),
                y=torch.cat([y, torch.full((1,), 1000, device="cuda")]))[:1]
        picked[params] = (got, _scaled_err(got, want))
        del net
    params_apart = _scaled_err(picked["raw"][0], picked["ema"][0])

    dropped = "blocks.1.freq_mamba.mixer.x_proj.weight"
    bad = os.path.join(tmp, "missing-key.pt")
    torch.save({"ema": {k: v for k, v in sds["ema"].items()
                        if k != dropped}}, bad)
    try:
        sample.main(_sample_argv(bad, os.path.join(tmp, "quick"),
                                 "--sampling-method", "euler",
                                 "--num-sampling-steps", "2"))
        refused = False
    except ValueError as e:
        refused = dropped in str(e)
    os.remove(bad)

    rec_out = {"phase": "sample-dopri5", "model": "DiM-L/2",
               "image_size": 256, "dtype": "bfloat16", "cfg_scale": 1.4,
               "batch": DOPRI5_BATCH, "nfe": nfe, "seconds": rec["seconds"],
               "s_per_image": rec["seconds"] / DOPRI5_BATCH,
               "decode_seconds": rec["decode_seconds"],
               "launches": launches, "pngs": len(pngs), "png_shapes": sizes,
               "finite": finite,
               "latent_std": rec["samples"].float().std().item(),
               "params_err": {k: v[1] for k, v in picked.items()},
               "params_apart": params_apart, "missing_key_refused": refused}
    emit(rec_out)
    # one CLI call through the card: the same weights, the same ops
    if (not finite or len(pngs) != DOPRI5_BATCH
            or sizes != [(256, 256, 3)]
            or launches["selective_scan_fwd"] != 32 * (nfe + 1)
            or launches["selective_scan_fwd_train"] != 0
            or launches["selective_scan_bwd"] != 0
            or max(v[1] for v in picked.values()) > 1e-3
            or not params_apart > 0.05 or not refused):
        raise AssertionError(f"sample-dopri5 phase failed: {rec_out}")
    torch.cuda.empty_cache()
    return launches


def phase_sample_sde_512(tmp, sds):
    """The 256-px checkpoint adapted to 512 px (`adapt_checkpoint`: the
    position embedding resized bicubically as the JAX package does), saved,
    and sampled through `python -m dimsum_torch.sample SDE` at 512 px:
    Euler-Maruyama over SDE_512_STEPS grid points, diffusion sigma_t, the
    Mean last step, CFG 1.4, bf16, 2 images.  The velocity model's SDE
    drift calls the model twice (drift and score): 2 (SDE_512_STEPS - 1)
    + 2 calls, each with 32 scan launches and 36 attention launches, all
    through the sm90 kernel.  Counts set to 0 just before and read just
    after; finite samples."""
    import os

    import torch

    from dimsum_torch import sample
    from dimsum_torch.models.dim import DiM
    from dimsum_torch.utils.ckpt import adapt_checkpoint, resize_pos_embed

    with torch.device("meta"):
        template = DiM(_dim_l2_config(512)).state_dict()
    adapted = adapt_checkpoint(sds["ema"], template)
    pos_ok = torch.equal(adapted["pos_embed"],
                         resize_pos_embed(sds["ema"]["pos_embed"], 1024))
    path = os.path.join(tmp, "dim-l2-512-adapted.pt")
    torch.save({"ema": adapted}, path)
    del adapted

    counts = {**_zeroed_scan_counts(), **_zeroed_attention_counts()}
    rec = sample.main(["SDE", *DIM_L2_ARGS, "--image-size", "512", "--ckpt",
                       path, "--sample-dir", os.path.join(tmp, "sde"),
                       "--diffusion-form", "sigma", "--last-step", "Mean",
                       "--num-sampling-steps", str(SDE_512_STEPS),
                       "--cfg-scale", "1.4", "--global-batch-size", "2"])
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counts.items()}
    calls = 2 * (SDE_512_STEPS - 1) + 2
    finite = bool(torch.isfinite(rec["samples"]).all())
    out = {"phase": "sample-sde-512", "model": "DiM-L/2", "image_size": 512,
           "dtype": "bfloat16", "steps": SDE_512_STEPS, "model_calls": calls,
           "seconds": rec["seconds"], "launches": launches,
           "shape": list(rec["samples"].shape), "finite": finite,
           "pos_embed_resized": pos_ok,
           "sample_std": rec["samples"].float().std().item()}
    emit(out)
    if (not finite or not pos_ok or out["shape"] != [2, 4, 64, 64]
            or launches != {"selective_scan_fwd_train": 0,
                            "selective_scan_bwd": 0,
                            **_attention_launches(calls,
                                                  "full_attention_sm90")}):
        raise AssertionError(f"sample-sde-512 phase failed: {out}")
    torch.cuda.empty_cache()
    return path


def phase_sample_512_fp32(tmp, path):
    """The default fp32 512-px sampling path: the adapted checkpoint at
    `path` sampled through `python -m dimsum_torch.sample ODE` in its
    default dtype, fp32 (TF32 off, the CLI's default), Euler over
    FP32_512_STEPS grid points, CFG 1.4, 2 images: FP32_512_STEPS - 1 drift
    calls, each with 32 scan launches and 36 attention launches, all
    through the fp32 attention kernel.  Counts set to 0 just before and
    read just after; finite samples.  Returns the launches."""
    import os

    import torch

    from dimsum_torch import sample

    counts = _zeroed_attention_counts()
    rec = sample.main(["ODE", *[a for a in DIM_L2_ARGS if a != "--bf16"],
                       "--image-size", "512", "--ckpt", path,
                       "--sample-dir", os.path.join(tmp, "ode-fp32"),
                       "--sampling-method", "euler",
                       "--num-sampling-steps", str(FP32_512_STEPS),
                       "--cfg-scale", "1.4", "--global-batch-size", "2"])
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counts.items()}
    calls = FP32_512_STEPS - 1
    finite = bool(torch.isfinite(rec["samples"]).all())
    out = {"phase": "sample-512-fp32", "model": "DiM-L/2", "image_size": 512,
           "dtype": str(rec["samples"].dtype).split(".")[-1],
           "steps": FP32_512_STEPS, "model_calls": calls,
           "seconds": rec["seconds"],
           "seconds_per_call": rec["seconds"] / calls, "launches": launches,
           "shape": list(rec["samples"].shape), "finite": finite,
           "sample_std": rec["samples"].float().std().item()}
    emit(out)
    if (not finite or out["shape"] != [2, 4, 64, 64]
            or out["dtype"] != "float32"
            or launches != _attention_launches(calls, "full_attention_f32")):
        raise AssertionError(f"sample-512-fp32 phase failed: {out}")
    torch.cuda.empty_cache()
    return launches


def phase_likelihood(tmp, ckpt):
    """`python -m dimsum_torch.sample ODE --likelihood` at cfg 1.0, 256 px,
    bf16, 2 images: the samples by Euler over LIKELIHOOD_STEPS grid points
    (kernel 1), then their bits/dim by the augmented reverse ODE over the
    same grid, whose vector-Jacobian products take kernels 2 and 3: 32
    launches of each per drift call.  Counts set to 0 just before and read
    just after; finite bits/dim.  Then one augmented drift call of the fp32
    model (TF32 off) through the kernels and through the plain scan: the
    drift within 1e-3 and the vector-Jacobian product within 2e-3 of their
    scales (as the model and train-grad phases hold a forward and a
    gradient), the divergence estimate within 2e-3 of its terms' sum."""
    import os

    import torch

    from dimsum_torch import sample
    from dimsum_torch.models.dim import build_dim
    from dimsum_torch.transport import Sampler, create_transport

    counts = _zeroed_scan_counts()
    rec = sample.main(_sample_argv(
        ckpt, os.path.join(tmp, "likelihood"), "--sampling-method", "euler",
        "--num-sampling-steps", str(LIKELIHOOD_STEPS), "--likelihood",
        "--cfg-scale", "1.0", "--global-batch-size", "2"))
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counts.items()}
    bpd = rec["bpd"]
    calls = LIKELIHOOD_STEPS - 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = build_dim(_dim_l2_config(256), "cuda", seed=0)
    net.requires_grad_(False)
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn((2, 4, 32, 32), generator=g, device="cuda")
    y = torch.randint(0, 1000, (2,), generator=g, device="cuda")
    t = torch.full((2,), 0.3, device="cuda")
    eps = torch.randint(0, 2, x.shape, generator=g, device="cuda").float()         * 2 - 1
    sampler = Sampler(create_transport("GVP", "velocity"))
    aug_counts = _zeroed_scan_counts()
    dx, vjp = sampler.augmented_drift(x, t, net, eps, y=y)
    aug_launches = {k: c.launches for k, c in aug_counts.items()}
    for m in _mixers(net):
        m.scan_impl = "ref"
    dx_ref, vjp_ref = sampler.augmented_drift(x, t, net, eps, y=y)
    torch.cuda.synchronize()
    div, div_ref = (vjp * eps).sum((1, 2, 3)), (vjp_ref * eps).sum((1, 2, 3))
    div_err = ((div - div_ref).abs()
               / (vjp_ref * eps).abs().sum((1, 2, 3))).max().item()
    errs = {"drift": _scaled_err(dx, dx_ref), "vjp": _scaled_err(vjp, vjp_ref),
            "divergence": div_err}
    out = {"phase": "likelihood", "model": "DiM-L/2", "image_size": 256,
           "dtype": "bfloat16", "steps": LIKELIHOOD_STEPS,
           "seconds": rec["seconds"], "launches": launches,
           "bits_per_dim": bpd.tolist(),
           "finite": bool(torch.isfinite(bpd).all()),
           "fp32_check": {"errs": errs, "tol": {"drift": 1e-3, "vjp": 2e-3,
                                                "divergence": 2e-3},
                          "launches": aug_launches,
                          "divergence": div_ref.tolist()}}
    emit(out)
    if (not out["finite"]
            or launches["selective_scan_fwd"] != 32 * calls
            or launches["selective_scan_fwd_train"] != 32 * calls
            or launches["selective_scan_bwd"] != 32 * calls
            or aug_launches != {"selective_scan_fwd": 0,
                                "selective_scan_fwd_train": 32,
                                "selective_scan_bwd": 32}
            or not errs["drift"] <= 1e-3 or not errs["vjp"] <= 2e-3
            or not div_err <= 2e-3):
        raise AssertionError(f"likelihood phase failed: {out}")
    del net
    torch.cuda.empty_cache()
    return launches


def phase_sampling_path():
    """The sampling path from a checkpoint (sample-dopri5, sample-sde-512,
    sample-512-fp32, likelihood) on files written into a temporary
    directory, removed after.  Returns sample-512-fp32's launches."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        ckpt, sds, vae_path = write_checkpoints(tmp)
        phase_sample_dopri5(tmp, ckpt, sds, vae_path)
        launches = phase_sample_512_fp32(tmp, phase_sample_sde_512(tmp, sds))
        phase_likelihood(tmp, ckpt)
        return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA card", file=sys.stderr)
        return 1
    from dimsum_torch.ops import cuda_build
    from dimsum_torch.utils.device import card_name_and_power_limit

    card = card_name_and_power_limit(0)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": card, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    logs = cuda_build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": sorted(logs), "ptxas": [
              line.strip() for log in logs.values() for line in
              log.splitlines() if "registers" in line or "spill" in line]})

    scans = phase_kernel()
    phase_model()
    launches = phase_sample()
    train_scans = phase_kernel_train()
    phase_train_grad()
    launches.update(phase_train())
    phase_train_512()
    attn = phase_kernel_attn()
    phase_model_512()
    phase_model_512_bf16()
    launches["full_attention_sm90"] = \
        phase_sample_512()["full_attention_sm90"]
    states = phase_kernel_state()
    launches["selective_scan_fwd_state"] = \
        phase_sample_sp_512()["selective_scan_fwd_state"]
    norms = phase_kernel_norm()
    convx = phase_kernel_convx()
    phase_model_fused()
    phase_train_grad_fused()
    launches.update(phase_sample_fused())
    phase_sample_fused_512()
    fp32_launches = phase_sampling_path()
    for name in ("full_attention_f32", "full_attention_first"):
        launches[name] = fp32_launches[name]

    # the scan at the 256-px mixer shape, with the 512-px one (L 1024)
    # beside it
    main_case, long_case = scans["mixer-bf16"], scans["L1024-bf16"]
    kernels = [{
        "name": "selective_scan_fwd",
        "route": "cuda",
        "source": "dimsum_torch/csrc/selective_scan_fwd.cu",
        "replaces": "dimsum_tpu/ops/selective_scan.py:426",
        "launches": launches["selective_scan_fwd"],
        "max_abs_err": max(r["max_abs_err"] for r in scans.values()),
        "ms": main_case["ms"],
        "device_ms": main_case["device_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None,
        "L1024_ms": long_case["ms"],
        "L1024_device_ms": long_case["device_ms"],
        "L1024_plain_ms": long_case["plain_ms"],
        "L1024_bound_ms": long_case["bound_ms"],
    }]
    # the state entry at the sample-sp-512 shape: `ms` the first SP pass
    # (zero state in, the last state out), `h0_ms` the second (seeded)
    sp_case = states["sp-bf16"]
    kernels.append({
        "name": "selective_scan_fwd_state",
        "route": "cuda",
        "source": "dimsum_torch/csrc/selective_scan_fwd.cu",
        "replaces": "dimsum_tpu/ops/selective_scan.py:724",
        "replaces_also": "dimsum_tpu/ops/selective_scan.py:738 (has_h0)",
        "launches": launches["selective_scan_fwd_state"],
        "max_abs_err": max(r["max_abs_err"] for r in states.values()),
        "ms": sp_case["ms"],
        "device_ms": sp_case["device_ms"],
        "plain_ms": sp_case["plain_ms"],
        "bound_ms": sp_case["bound_ms"],
        "bound_by": sp_case["bound_by"],
        "library_ms": None,
        "h0_ms": sp_case["h0_ms"],
        "h0_device_ms": sp_case["h0_device_ms"],
        "h0_bound_ms": sp_case["h0_bound_ms"],
    })
    train_case, train_long = train_scans["train-bf16"], \
        train_scans["L1024-bf16"]
    for name, key, source, replaces in (
            ("selective_scan_fwd_train", "fwd_train",
             "dimsum_torch/csrc/selective_scan_fwd_train.cu",
             "dimsum_tpu/ops/selective_scan_bwd.py:51"),
            ("selective_scan_bwd", "bwd",
             "dimsum_torch/csrc/selective_scan_bwd.cu",
             "dimsum_tpu/ops/selective_scan_bwd.py:96")):
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r[key]["max_abs_err"]
                               for r in train_scans.values()),
            "ms": train_case[key]["ms"],
            "device_ms": train_case[key]["device_ms"],
            "plain_ms": train_case[key]["plain_ms"],
            "bound_ms": train_case[key]["bound_ms"],
            "bound_by": train_case[key]["bound_by"],
            "library_ms": None,
            "L1024_ms": train_long[key]["ms"],
            "L1024_device_ms": train_long[key]["device_ms"],
            "L1024_plain_ms": train_long[key]["plain_ms"],
            "L1024_bound_ms": train_long[key]["bound_ms"]})
    # the attention: bf16 at Dh 64 (the bf16 sampling paths) through the
    # sm90 kernel, fp32 at Dh 64 (the default fp32 sampling path,
    # sample-512-fp32) through the fp32 kernel, each with its cross-shape
    # numbers beside the DiT ones.  The first kernel serves Dh 72-128, which
    # no DiM-L/2 path runs: its launches are sample-512-fp32's (0), its
    # times the fp32 cases', on the fp32 kernel's inputs
    def attention_record(name, source, dit, cross, timed):
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": "dimsum_tpu/ops/full_attention.py:82",
            "launches": launches[name],
            "max_abs_err": max(timed(dit)["max_abs_err"],
                               timed(cross)["max_abs_err"]),
            "ms": timed(dit)["ms"], "device_ms": timed(dit)["device_ms"],
            "plain_ms": dit["plain_ms"],
            "bound_ms": dit["bound_ms"], "bound_by": dit["bound_by"],
            "library_ms": dit["library_ms"],
            "library_device_ms": dit["library_device_ms"],
            "cross_ms": timed(cross)["ms"],
            "cross_device_ms": timed(cross)["device_ms"],
            "cross_plain_ms": cross["plain_ms"],
            "cross_bound_ms": cross["bound_ms"],
            "cross_library_ms": cross["library_ms"],
            "cross_library_device_ms": cross["library_device_ms"]}

    for name, case in (("full_attention_sm90", "bf16"),
                       ("full_attention_f32", "fp32")):
        kernels.append(attention_record(
            name, f"dimsum_torch/csrc/{name}.cu", attn[f"dit-{case}"],
            attn[f"cross-{case}"], lambda r: r))
    kernels.append(attention_record(
        "full_attention_first", "dimsum_torch/csrc/full_attention.cu",
        attn["dit-fp32"], attn["cross-fp32"], lambda r: r["first_kernel"]))
    # the main-path cases: bf16, the add + norm site and norm_2 (no single
    # PyTorch call computes any of the three functions: library_ms null)
    for name, source, replaces, cases, main_case in (
            ("add_norm", "dimsum_torch/csrc/add_norm.cu",
             "dimsum_tpu/ops/norms.py:81", norms["add_norm"], "bfloat16"),
            ("norm_modulate", "dimsum_torch/csrc/norm_modulate.cu",
             "dimsum_tpu/ops/norms.py:349", norms["norm_modulate"],
             "norm_2-bfloat16"),
            ("conv_xproj", "dimsum_torch/csrc/conv_xproj.cu",
             "dimsum_tpu/ops/conv_xproj.py:123", convx, "mixer-bf16")):
        case = cases[main_case]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in cases.values()),
            "ms": case["ms"], "device_ms": case["device_ms"],
            "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
            "library_ms": None})
    # norm_2 and conv_xproj at the fused 512-px sampling shape (L 1024);
    # norm_2 at 256 px also with a cold L2
    by_name = {rec["name"]: rec for rec in kernels}
    mods = norms["norm_modulate"]
    for name, long_case in (("norm_modulate", mods["norm_2-L1024-bfloat16"]),
                            ("conv_xproj", convx["L1024-bf16"])):
        by_name[name].update({"L1024_ms": long_case["ms"],
                              "L1024_device_ms": long_case["device_ms"],
                              "L1024_plain_ms": long_case["plain_ms"],
                              "L1024_bound_ms": long_case["bound_ms"]})
    by_name["norm_modulate"]["cold_device_ms"] = \
        mods["norm_2-bfloat16"]["cold_device_ms"]
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
