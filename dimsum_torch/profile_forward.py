"""Where the time of one sampling step, or one training step, goes on the
card.

Profiles with `torch.profiler` either the CFG forward of the bench protocol
(DiM-L/2 at 256 px, or 512 px with `--image-size 512`, seeded random
weights, 2 x batch rows; `--model` another model of the zoo, built as the
sampling CLI builds it from its name and the CLI's defaults for the rest,
e.g. DiT-XL/2) or, with `--train`, one train step of
`dimsum_torch.train_bench` (batch rows, bf16 over fp32 weights, AdamW,
clip, EMA).  Prints JSON lines: the host wall time per step
(CUDA-synchronized, unprofiled), the device time per step by kernel class
(the selective-scan kernels, the full-block attention kernels, matmul,
library attention, optimizer, the rest) and the device's idle share, then
the top kernels by device time.  The flags of `dimsum_torch.bench` select
the fused-kernel configuration, whose three kernels (add + norm, norm +
modulate, conv + x_proj) are classes of their own.

    python -m dimsum_torch.profile_forward --batch 12 --dtype bf16
    python -m dimsum_torch.profile_forward --image-size 512
    python -m dimsum_torch.profile_forward --model DiT-XL/2 \
        --image-size 512 --batch 4
    python -m dimsum_torch.profile_forward --train --batch 16
    python -m dimsum_torch.profile_forward --pallas-norm --fused-norm \
        --conv-xproj [--pending-tail 2]
    python -m dimsum_torch.profile_forward --train --grad-checkpoint \
        [--remat-policy scan]

The last profiles train steps under remat (`train_bench`'s flags).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dimsum_torch import cli, train_bench
from dimsum_torch.bench import (DTYPES, IMAGE_SIZES, add_fused_flags,
                                fused_settings)
from dimsum_torch.models.dim import DiM_models, build_dim, forward_with_cfg
from dimsum_torch.models.factory import build_model
from dimsum_torch.utils.device import card_name_and_power_limit, resolve_device

ITERS = 5  # steps per timed and per profiled window
CLASSES = (
    ("selective_scan", ("scan_fwd_kernel",)),
    ("selective_scan_fwd_train", ("scan_fwd_train_kernel",
                                  "scan_fwd_train_states_kernel")),
    ("selective_scan_bwd", ("scan_bwd_kernel", "scan_bwd_carry_kernel")),
    ("full_block_attention", ("attn_sm90_kernel", "attn_fp32_sm90_kernel",
                              "attn_bf16_kernel", "attn_f32_kernel")),
    # before the library classes: these names hold none of their keys
    ("add_norm", ("add_norm_kernel",)),
    ("norm_modulate", ("norm_mod_kernel",)),
    ("conv_xproj", ("conv_xproj_sm90_kernel", "conv_xproj_f32_kernel")),
    ("optimizer", ("multi_tensor_apply",)),
    ("attention", ("flash", "fmha", "attention", "attn")),
    ("matmul", ("gemm", "nvjet", "sm90_xmma", "cutlass", "cublas")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def zoo_config(model: str, image_size: int, dtype: str, fused: dict):
    """The config the sampling CLI builds for `--model model --image-size
    image_size` (1000 classes, label dropout 0.1 for CFG's null class, the
    CLI's defaults otherwise), with the fused switches the config has."""
    p = argparse.ArgumentParser()
    cli.add_model_args(p)
    cli.add_moe_args(p)
    cfg = cli.model_config(p.parse_args(
        ["--model", model, "--image-size", str(image_size), "--num-classes",
         "1000", "--label-dropout", "0.1",
         *(["--bf16"] if dtype == "bf16" else [])]))
    fields = {f.name for f in dataclasses.fields(cfg)}
    unknown = {k for k, on in fused.items() if on and k not in fields}
    if unknown:
        raise ValueError(f"{model} has no switch {sorted(unknown)}")
    return dataclasses.replace(
        cfg, **{k: v for k, v in fused.items() if k in fields})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--model", default="DiM-L/2",
                    help="without --train: DiM-L/2 (the bench protocol's "
                         "configuration) or another model of the zoo, "
                         "built from its name by the CLI's model_config")
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--train", action="store_true",
                    help="profile train steps (batch rows) instead of CFG "
                         "forwards (2 x batch rows)")
    ap.add_argument("--image-size", type=int, default=256,
                    choices=IMAGE_SIZES,
                    help="pixels; 512 -> latent 64, L = 1024 tokens")
    add_fused_flags(ap)
    ap.add_argument("--grad-checkpoint", action="store_true",
                    help="with --train: remat each block")
    ap.add_argument("--remat-policy", default=None,
                    help="with --grad-checkpoint: what remat keeps")
    args = ap.parse_args(argv)
    if args.train and args.model != "DiM-L/2":
        ap.error("--train profiles train_bench's DiM-L/2 only")
    fused = fused_settings(args)
    latent = args.image_size // 8
    dev = resolve_device("cuda")

    if args.train:
        _, step = train_bench.setup(batch=args.batch,
                                    bf16=args.dtype == "bf16", device=dev,
                                    image_size=args.image_size,
                                    grad_checkpoint=args.grad_checkpoint,
                                    remat_policy=args.remat_policy, **fused)
        rows, grad_mode = args.batch, torch.enable_grad()
    elif args.model == "DiM-L/2":
        cfg = DiM_models["DiM-L/2"](img_resolution=latent, num_classes=1000,
                                    use_attn_every_k_layers=4,
                                    dtype=DTYPES[args.dtype], **fused)
        net = build_dim(cfg, dev, seed=0)
    else:
        cfg = zoo_config(args.model, args.image_size, args.dtype, fused)
        net = build_model(cfg, dev, seed=0)
    if not args.train:
        g = torch.Generator(device=dev).manual_seed(0)
        half = torch.randn((args.batch, 4, latent, latent), generator=g,
                           device=dev)
        x = torch.cat([half, half])
        t = torch.full((2 * args.batch,), 0.5, device=dev)
        y = torch.cat([torch.randint(0, 1000, (args.batch,), generator=g,
                                     device=dev),
                       torch.full((args.batch,), 1000, device=dev)])

        def step():
            return forward_with_cfg(net, x, t, y, cfg_scale=1.4)

        rows, grad_mode = 2 * args.batch, torch.inference_mode()

    with grad_mode:
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

    # device kernels only: a record_function range (the optimizer's
    # "Optimizer.step#AdamW.step") also shows on the device track, and would
    # count its kernels twice
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    per_class, launches = {}, 0
    for e in kernels:
        cls = kernel_class(e.key)
        per_class[cls] = per_class.get(cls, 0.0) + (
            e.self_device_time_total / 1e3 / ITERS)
        launches += e.count
    busy_ms = sum(per_class.values())
    print(json.dumps({
        "card": card_name_and_power_limit(dev.index or 0),
        "step": "train" if args.train else "cfg_forward",
        "model": "DiM-L/2" if args.train else args.model,
        "image_size": args.image_size, "rows": rows, "dtype": args.dtype,
        "fused": fused, "grad_checkpoint": args.grad_checkpoint,
        "remat_policy": args.remat_policy,
        "wall_ms_per_step": wall_ms, "device_ms_per_step": busy_ms,
        "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
        "kernel_launches_per_step": launches / ITERS,
        "device_ms_by_class": per_class}))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    for e in top:
        print(json.dumps({
            "kernel": e.key[:120], "class": kernel_class(e.key),
            "calls_per_step": e.count / ITERS,
            "device_ms_per_step":
                e.self_device_time_total / 1e3 / ITERS}))


if __name__ == "__main__":
    main()
