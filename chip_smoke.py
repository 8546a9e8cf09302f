#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`dimsum_torch`) on one NVIDIA card:
its sampling and training paths at full DiM-L/2 width.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

  1. device   the card's name and power limit (nvidia-smi).
  2. build    nvcc builds every kernel source of the port (one process per
              source, all started together) into build/dimsum_torch/.
  3. kernel   the selective-scan kernel against its plain PyTorch version
              at the DiM-L/2 mixer shape (batch 24, L 256, dim 1024, N 16,
              r 32) in bf16 and fp32, forward and reversed, plus a ragged
              dim and L 1024: max error against the stated tolerance,
              kernel and plain times (CUDA events), and the bound.
  4. model    full-width DiM-L/2 at 256 px (depth 16, seeded random
              weights), one CFG forward in fp32 with TF32 off through the
              kernel and through the plain scan: they must agree, and the
              kernel must launch exactly 32 times per forward.
  5. sample   the sampling path: `dimsum_torch.bench.run` (batch 12, CFG
              1.4, GVP velocity, 250 Euler grid points, bf16).  Launch
              counts are set to 0 just before and read just after; the
              samples must be finite.
  6. kernel-train  the training pair, kernels 2 (forward with saved
              states) and 3 (backward), against their plain versions at
              the training mixer shape (batch 16, L 256, dim 1024, N 16,
              r 32) in bf16 and fp32, forward and reversed, plus a ragged
              dim: max error against the stated tolerance, kernel and
              plain times, and the bound.
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
  9. kernels  one {"kernels": [...]} line, then the nvidia-smi line, then
              {"ok": true, "device": {...}} as the last line.

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
STEPS = 250  # Euler grid points of the bench protocol
# timed and untimed steps of the train phase, as train_bench's defaults
TRAIN_STEPS, TRAIN_WARMUP = 10, 3


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


def scan_bound(x):
    """Least time for one scan call: each input read once and the output
    written once, over HBM bandwidth; and the fp32 operations, 2r (dt
    expansion) + 7N (per state: dt*A, exp2, du*B, two FMAs) + 12 (bias,
    softplus, du, skip, gate) per (b, t, d), over the fp32 peak."""
    batch, L, dim = x["u"].shape
    r, n = x["dt_w"].shape[0], x["A"].shape[1]
    nbytes = sum(v.numel() * v.element_size() for v in x.values())
    nbytes += x["u"].numel() * x["u"].element_size()  # the output
    flops = batch * L * dim * (2 * r + 7 * n + 12)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


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
            plain_ms = cuda_ms(lambda: selective_scan_dtlow(
                *args, impl="ref", **kw), iters=3, warmup=1)
        bound_ms, bound_by, nbytes, flops = scan_bound(x)
        rec = {"phase": "kernel", "case": name, "shape": [batch, L, dim,
                                                          16, 32],
               "dtype": str(dtype).split(".")[-1], "reverse": reverse,
               "max_abs_err": err.max().item(),
               "max_abs_ref": want.abs().max().item(), "tol": tol,
               "ok": ok, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
               "flop": flops}
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
    """Least time of the two training kernels on x's shapes, each input
    read once and each output written once over HBM bandwidth, and the
    fp32 operations over the fp32 peak.  Kernel 2: kernel 1's inputs, y
    (u's type), o and the states (fp32); 2r + 7N + 12 flop per (b, t, d).
    Kernel 3 (with its partial sums): u, dt_low, dt_w, A, B, C, bias, go
    and the states in, du, ddt (fp32) and dA, dB, dC out; 2r + 20N + 18
    flop per (b, t, d) (replay: expansion, softplus, sigmoid, 5 per state;
    reverse step: 15 per state)."""
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
    for name, nbytes, flops in (
            ("fwd_train", fwd_bytes, big * (2 * r + 7 * n + 12)),
            ("bwd", bwd_bytes, big * (2 * r + 20 * n + 18))):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        out[name] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations",
                     nbytes, flops)
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
        bounds = train_bounds(x, ss.TRAIN_CHUNK)
        rec = {"phase": "kernel-train", "case": name,
               "shape": [batch, L, dim, 16, 32],
               "dtype": str(dtype).split(".")[-1], "reverse": reverse,
               "scaled_err": errs, "tol_fp32": 1e-4, "tol_bf16": 1.6e-2,
               "ok": ok, "low_precision_outputs": low,
               "fwd_train": {"max_abs_err": fwd_err, "ms": fwd_ms,
                             "plain_ms": fwd_plain,
                             "bound_ms": bounds["fwd_train"][0],
                             "bound_by": bounds["fwd_train"][1],
                             "bytes": bounds["fwd_train"][2],
                             "flop": bounds["fwd_train"][3]},
               "bwd": {"max_abs_err": bwd_err, "ms": bwd_ms,
                       "plain_ms": bwd_plain, "bound_ms": bounds["bwd"][0],
                       "bound_by": bounds["bwd"][1],
                       "bytes": bounds["bwd"][2], "flop": bounds["bwd"][3]}}
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


def phase_train():
    import torch

    from dimsum_torch import train_bench
    from dimsum_torch.ops import selective_scan as ss

    counts = {"selective_scan_fwd": ss.selective_scan_cuda,
              "selective_scan_fwd_train": ss.selective_scan_fwd_train_cuda,
              "selective_scan_bwd": ss.selective_scan_bwd_core_cuda}
    for c in counts.values():
        c.launches = 0
    record, state = train_bench.run(batch=16, bf16=True, steps=TRAIN_STEPS,
                                    warmup=TRAIN_WARMUP, device="cuda",
                                    seed=0)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counts.items()}
    init = dict(_train_model(torch.bfloat16, seed=0).named_parameters())
    # a parameter whose last gradient is well above Adam's eps must have
    # moved (a smaller one may move by less than its rounding); one without
    # a gradient (CondMamba's cond_proj, out of the graph) must not
    moved, wrong, no_grad, ema_moved = 0, [], [], 0
    for name, p in state.model.named_parameters():
        changed = not torch.equal(p, init[name])
        moved += changed
        ema_moved += not torch.equal(state.ema_params[name], init[name])
        if p.grad is None:
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

    main_case = scans["mixer-bf16"]
    kernels = [{
        "name": "selective_scan_fwd",
        "route": "cuda",
        "source": "dimsum_torch/csrc/selective_scan_fwd.cu",
        "replaces": "dimsum_tpu/ops/selective_scan.py:426",
        "launches": launches["selective_scan_fwd"],
        "max_abs_err": max(r["max_abs_err"] for r in scans.values()),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None,
    }]
    train_case = train_scans["train-bf16"]
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
            "plain_ms": train_case[key]["plain_ms"],
            "bound_ms": train_case[key]["bound_ms"],
            "bound_by": train_case[key]["bound_by"],
            "library_ms": None})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
