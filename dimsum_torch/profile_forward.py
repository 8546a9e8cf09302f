"""Where the time of one sampling step goes on the card.

Profiles the CFG forward of the bench protocol (DiM-L/2 at 256 px, seeded
random weights, 2 x batch rows, bf16) with `torch.profiler` and prints JSON
lines: the host wall time per forward (CUDA-synchronized, unprofiled), the
device time per forward by kernel class (selective scan, matmul, attention,
the rest) and the device's idle share, then the top kernels by device time.

    python -m dimsum_torch.profile_forward --batch 12 --dtype bf16
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dimsum_torch.bench import DTYPES
from dimsum_torch.models.dim import DiM_models, build_dim, forward_with_cfg
from dimsum_torch.utils.device import card_name_and_power_limit, resolve_device

ITERS = 5  # forwards per timed and per profiled window
CLASSES = (
    ("selective_scan", ("scan_fwd_kernel",)),
    ("attention", ("flash", "fmha", "attention", "attn")),
    ("matmul", ("gemm", "nvjet", "sm90_xmma", "cutlass", "cublas")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")

    cfg = DiM_models["DiM-L/2"](img_resolution=32, num_classes=1000,
                                use_attn_every_k_layers=4,
                                dtype=DTYPES[args.dtype])
    net = build_dim(cfg, dev, seed=0)
    g = torch.Generator(device=dev).manual_seed(0)
    half = torch.randn((args.batch, 4, 32, 32), generator=g, device=dev)
    x = torch.cat([half, half])
    t = torch.full((2 * args.batch,), 0.5, device=dev)
    y = torch.cat([torch.randint(0, 1000, (args.batch,), generator=g,
                                 device=dev),
                   torch.full((args.batch,), 1000, device=dev)])

    def step():
        return forward_with_cfg(net, x, t, y, cfg_scale=1.4)

    with torch.inference_mode():
        for _ in range(3):
            step()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(ITERS):
            step()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) / ITERS * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                step()
            torch.cuda.synchronize(dev)

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    per_class, launches = {}, 0
    for e in kernels:
        cls = kernel_class(e.key)
        per_class[cls] = per_class.get(cls, 0.0) + (
            e.self_device_time_total / 1e3 / ITERS)
        launches += e.count
    busy_ms = sum(per_class.values())
    print(json.dumps({
        "card": card_name_and_power_limit(dev.index or 0),
        "rows": 2 * args.batch, "dtype": args.dtype,
        "wall_ms_per_forward": wall_ms, "device_ms_per_forward": busy_ms,
        "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
        "kernel_launches_per_forward": launches / ITERS,
        "device_ms_by_class": per_class}))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    for e in top:
        print(json.dumps({
            "kernel": e.key[:120], "class": kernel_class(e.key),
            "calls_per_forward": e.count / ITERS,
            "device_ms_per_forward":
                e.self_device_time_total / 1e3 / ITERS}))


if __name__ == "__main__":
    main()
