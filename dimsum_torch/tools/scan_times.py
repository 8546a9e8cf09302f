"""Device ms of the scan kernels at the main path's shapes, to compare two
checkouts of the port on one card.  Run it from each, alternated (parent,
change, change, parent), with PYTHONPATH at the checkout to time:

    PYTHONPATH=OLD_CHECKOUT python dimsum_torch/tools/scan_times.py
    PYTHONPATH=. python dimsum_torch/tools/scan_times.py

Cases (N 16, r 32, seeded inputs): kernel 1 at the sampling mixer shape (24
x 256 x 1024) in bf16 and fp32 and at L 1024 (24 x 1024 x 1024, bf16);
kernels 2 and 3 at the training mixer shapes (16 x 256 x 1024 and 4 x 1024 x
1024) in bf16 and fp32.  Each case's time is the sum over its kernels of
the median launch duration in torch.profiler's CUDA activity, over
`--iters` calls.  Prints one JSON line: the sources' directory, the card,
and each case's device ms.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics

import torch

CASES = [("fwd", 24, 256, "bfloat16"), ("fwd", 24, 256, "float32"),
         ("fwd", 24, 1024, "bfloat16")] + [
    (k, b, L, dt) for k in ("fwd_train", "bwd")
    for b, L in ((16, 256), (4, 1024)) for dt in ("bfloat16", "float32")]


def _inputs(batch, L, dtype, seed=0, dim=1024, n=16, r=32):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    dt = torch.exp(torch.rand(dim, generator=g, device="cuda")
                   * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    x = dict(u=randn(batch, L, dim), dt_low=randn(batch, L, r),
             dt_w=randn(r, dim) / math.sqrt(r),
             A=-torch.arange(1, n + 1, device="cuda",
                             dtype=torch.float32).repeat(dim, 1),
             B=randn(batch, L, n), C=randn(batch, L, n),
             D=torch.ones(dim, device="cuda"), z=randn(batch, L, dim),
             delta_bias=dt + torch.log(-torch.expm1(-dt)))
    return {k: (v if k in ("A", "D", "delta_bias") else v.to(dtype))
            .contiguous() for k, v in x.items()}


def _call(kernel, x):
    from dimsum_torch.ops import selective_scan as ss

    args = [x[k] for k in ("u", "dt_low", "dt_w", "A", "B", "C")]
    if kernel == "fwd":
        return lambda: ss.selective_scan_cuda(
            *args, x["D"], x["z"], x["delta_bias"], True)
    if kernel == "fwd_train":
        return lambda: ss.selective_scan_fwd_train_cuda(
            *args, x["D"], x["z"], x["delta_bias"], True)
    _, _, bnd = ss.selective_scan_fwd_train_cuda(*args, x["D"], x["z"],
                                                 x["delta_bias"], True)
    go = torch.randn(x["u"].shape, device="cuda")
    return lambda: ss.selective_scan_bwd_core_cuda(
        *args, x["delta_bias"], True, go, bnd)


def device_ms(fn, cls, iters):
    """The sum over the kernels of class `cls` of their median launch
    duration in one profiler window of `iters` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dimsum_torch.profile_forward import kernel_class

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    durations = {}
    for e in prof.events():
        us = e.time_range.elapsed_us()
        if (e.device_type == DeviceType.CUDA and us > 0
                and kernel_class(e.name) == cls):
            durations.setdefault(e.name, []).append(us)
    return sum(statistics.median(v) for v in durations.values()) / 1e3


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=50)
    args = p.parse_args(argv)
    from dimsum_torch.ops import cuda_build

    classes = {"fwd": "selective_scan", "fwd_train":
               "selective_scan_fwd_train", "bwd": "selective_scan_bwd"}
    out = {"sources": str(cuda_build.CSRC_DIR),
           "card": torch.cuda.get_device_name(0), "device_ms": {}}
    with torch.no_grad():
        for kernel, batch, L, dtype in CASES:
            x = _inputs(batch, L, getattr(torch, dtype))
            out["device_ms"][f"{kernel}-{batch}x{L}-{dtype}"] = device_ms(
                _call(kernel, x), classes[kernel], args.iters)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
