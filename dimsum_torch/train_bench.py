"""Training benchmark of the port: the protocol of the JAX package's
`benchmarks/train_bench.py` on PyTorch/CUDA.

DiM-L/2 "combined" (hidden 1024, depth 16, CondMamba, RMSNorm with an fp32
residual, learnable sin-cos APE, a shared 16-head DiTBlock after every 4th
block) at 256 px (latent 32x32, L = 256 tokens) or, with `--image-size
512`, at 512 px (latent 64x64, L = 1024 tokens, where the attention takes
the full-block kernel, whose backward recomputes through its plain
version), seeded random weights kept in fp32 and computed in bf16, label
dropout 0.1 and stochastic depth 0.1 (scripts/train.sh), GVP velocity flow
matching with uniform t, AdamW (lr 1e-4, betas (0.9, 0.999), eps 1e-8, wd
0), global-norm clip 1.0 and EMA 0.9999, on one batch of seeded random
latents and labels.  `warmup` untimed steps, then `steps` steps timed with
CUDA events.

    python -m dimsum_torch.train_bench --batch 16 --steps 10 --warmup 3
    python -m dimsum_torch.train_bench --image-size 512 --batch 4
    python -m dimsum_torch.train_bench --pallas-norm --fused-norm \
        --conv-xproj [--pending-tail 2]
    python -m dimsum_torch.train_bench --grad-checkpoint [--remat-policy scan]

The third runs the JAX package's fused-kernel configuration (the flags of
`dimsum_torch.bench`, or the JAX environment switches they stand for),
the last remat (`DiMConfig.grad_checkpoint` and `remat_policy`), which
trades step time for peak memory.

Prints one JSON line: s/step and img/s on this card, with the card's name
and power limit, the loss and grad norm of every step, and the peak device
memory.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from dimsum_torch.bench import (IMAGE_SIZES, add_fused_flags, fused_config,
                                fused_settings)
from dimsum_torch.models.dim import DiM_models, build_dim
from dimsum_torch.parallel import (create_optimizer, create_train_state,
                                   make_train_step)
from dimsum_torch.transport import create_transport
from dimsum_torch.utils.device import card_name_and_power_limit, resolve_device


def setup(model: str = "DiM-L/2", batch: int = 16, bf16: bool = True,
          grad_accum: int = 1, device="cuda", seed: int = 0,
          image_size: int = 256, grad_checkpoint: bool = False,
          remat_policy=None, **fused):
    """The model, its train state and one batch of seeded random latents and
    labels at `image_size` pixels; `fused` sets the DiMConfig switches of
    the fused-kernel configuration (`bench.fused_config`), `grad_checkpoint`
    and `remat_policy` remat.  Returns (state, one_step), where one_step()
    runs one train step on that batch and returns its {"loss",
    "grad_norm"}."""
    if image_size not in IMAGE_SIZES:
        raise ValueError(f"image_size must be one of {IMAGE_SIZES}")
    dev = resolve_device(device)
    latent = image_size // 8
    cfg = DiM_models[model](
        img_resolution=latent, num_classes=1000, use_attn_every_k_layers=4,
        label_dropout=0.1, drop_path=0.1,
        dtype=torch.bfloat16 if bf16 else torch.float32,
        grad_checkpoint=grad_checkpoint, remat_policy=remat_policy,
        **fused_config(**fused))
    net = build_dim(cfg, dev, seed, train=True)
    transport = create_transport("GVP", "velocity")
    optimizer = create_optimizer(net, lr=1e-4, weight_decay=0.0)
    state = create_train_state(net, optimizer)
    step = make_train_step(net, transport, optimizer, max_grad_norm=1.0,
                           ema_decay=0.9999, use_labels=True,
                           grad_accum=grad_accum)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((batch, cfg.in_channels, latent, latent), generator=g,
                    device=dev)
    y = torch.randint(0, cfg.num_classes, (batch,), generator=g, device=dev)
    step_gen = torch.Generator(device=dev).manual_seed(seed + 1)
    return state, lambda: step(state, x, y, step_gen)


def run(model: str = "DiM-L/2", batch: int = 16, bf16: bool = True,
        steps: int = 10, warmup: int = 3, grad_accum: int = 1,
        device="cuda", seed: int = 0, image_size: int = 256,
        grad_checkpoint: bool = False, remat_policy=None, **fused):
    """Build the model and its train state, run `warmup` steps, then time
    `steps` steps.  `model` names a zoo entry (DiM-L/2, or a narrower one
    for a rehearsal on the CPU); `fused`, `grad_checkpoint` and
    `remat_policy` as in `setup`.  Returns (record, state)."""
    dev = resolve_device(device)
    state, one_step = setup(model, batch, bf16, grad_accum, dev, seed,
                            image_size, grad_checkpoint, remat_policy,
                            **fused)
    metrics = [one_step() for _ in range(warmup)]
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    metrics += [one_step() for _ in range(steps)]
    if cuda:
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        seconds = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state.model.parameters())
    record = {
        "metric": f"imagenet{image_size}_train_throughput",
        "value": batch * steps / seconds,
        "unit": "img/s",
        "s_per_step": seconds / steps,
        "steps": steps, "warmup": warmup, "batch": batch,
        "grad_accum": grad_accum, "model": model, "image_size": image_size,
        "dtype": "bf16" if bf16 else "fp32", "params_M": n_params / 1e6,
        "fused": fused_config(**fused),
        "grad_checkpoint": grad_checkpoint, "remat_policy": remat_policy,
        "loss": [m["loss"].item() for m in metrics],
        "grad_norm": [m["grad_norm"].item() for m in metrics],
        "max_memory_allocated_GB": (torch.cuda.max_memory_allocated(dev)
                                    / 1e9 if cuda else None),
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "card": card_name_and_power_limit(dev.index or 0) if cuda else None,
    }
    return record, state


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="DiM-L/2")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--fp32", action="store_true",
                    help="compute in fp32 (default: bf16)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--image-size", type=int, default=256,
                    choices=IMAGE_SIZES,
                    help="pixels; 512 -> latent 64, L = 1024 tokens")
    add_fused_flags(ap)
    ap.add_argument("--grad-checkpoint", action="store_true",
                    help="recompute each block in the backward (remat)")
    ap.add_argument("--remat-policy", default=None,
                    help="what remat keeps: none, dots, scan, dots_scan or "
                         "save:A+B over dots, scan_out, attn_out, conv_out")
    args = ap.parse_args(argv)
    record, _ = run(model=args.model, batch=args.batch, bf16=not args.fp32,
                    steps=args.steps, warmup=args.warmup,
                    grad_accum=args.grad_accum, device=args.device,
                    seed=args.seed, image_size=args.image_size,
                    grad_checkpoint=args.grad_checkpoint,
                    remat_policy=args.remat_policy, **fused_settings(args))
    print(json.dumps(record))


if __name__ == "__main__":
    main()
