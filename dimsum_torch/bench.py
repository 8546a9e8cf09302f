"""Sampling benchmark of the port: the protocol of the JAX package's
`bench.py` on PyTorch/CUDA.

DiM-L/2 "combined" at 256 px (latent 32x32, patch 2, L = 256 tokens) or,
with `--image-size 512`, at 512 px (latent 64x64, L = 1024 tokens, where
the attention takes the full-block kernel and the frequency half the
dwt_tokens + local_scan route): hidden 1024, depth 16, CondMamba, RMSNorm
with an fp32 residual, learnable sin-cos APE, a shared 16-head DiTBlock
after every 4th block, seeded random weights (no checkpoint ships with the
repo), CFG 1.4 on a doubled batch, GVP velocity transport, Euler over 250
grid points.  One untimed warm-up drift call precedes the timed run.

    python -m dimsum_torch.bench --batch 12 --steps 250 --dtype bf16 \
        --cfg 1.4 --device cuda [--image-size 512]

Prints one JSON line: images per second on this card, with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from dimsum_torch.models.dim import DiM_models, build_dim, forward_with_cfg
from dimsum_torch.transport import Sampler, create_transport
from dimsum_torch.utils.device import card_name_and_power_limit, resolve_device

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
IMAGE_SIZES = (256, 512)  # pixels; the latent is a size / 8 square


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(batch: int = 12, steps: int = 250, dtype: str = "bf16",
        cfg_scale: float = 1.4, device="cuda", seed: int = 0,
        model: str = "DiM-L/2", image_size: int = 256):
    """Build the model (`model` names a zoo entry: DiM-L/2, or a narrower
    one for a rehearsal on the CPU) at `image_size` pixels, sample once
    untimed for one drift call, then time one full sample.  Returns
    (record, samples of the conditional half)."""
    if image_size not in IMAGE_SIZES:
        raise ValueError(f"image_size must be one of {IMAGE_SIZES}")
    dev = resolve_device(device)
    latent = image_size // 8
    cfg = DiM_models[model](img_resolution=latent, num_classes=1000,
                            use_attn_every_k_layers=4, dtype=DTYPES[dtype])
    net = build_dim(cfg, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn((batch, cfg.in_channels, latent, latent), generator=g,
                    device=dev)
    z = torch.cat([z, z], dim=0)
    y = torch.cat([
        torch.randint(0, cfg.num_classes, (batch,), generator=g, device=dev),
        torch.full((batch,), cfg.num_classes, device=dev)])

    sampler = Sampler(create_transport("GVP", "velocity"))

    def model_fn(x, t, y=None):
        return forward_with_cfg(net, x, t, y, cfg_scale=cfg_scale,
                                in_channels=cfg.in_channels)

    with torch.inference_mode():
        sampler.sample_ode(sampling_method="euler", num_steps=2)(
            z, model_fn, y=y)
        _sync(dev)
        t0 = time.perf_counter()
        out = sampler.sample_ode(sampling_method="euler", num_steps=steps)(
            z, model_fn, y=y)
        _sync(dev)
        seconds = time.perf_counter() - t0
    record = {
        "metric": f"imagenet{image_size}_sampling_throughput_{steps}"
                  "step_cfg",
        "value": batch / seconds,
        "unit": "img/s",
        "seconds": seconds,
        "batch": batch,
        "steps": steps,
        "model": model,
        "image_size": image_size,
        "dtype": dtype,
        "cfg_scale": cfg_scale,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "card": (card_name_and_power_limit(dev.index or 0)
                 if dev.type == "cuda" else None),
    }
    return record, out[:batch]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=12,
                    help="images (CFG doubles the model batch)")
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--cfg", type=float, default=1.4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--image-size", type=int, default=256,
                    choices=IMAGE_SIZES,
                    help="pixels; 512 -> latent 64, L = 1024 tokens")
    args = ap.parse_args(argv)
    record, _ = run(batch=args.batch, steps=args.steps, dtype=args.dtype,
                    cfg_scale=args.cfg, device=args.device, seed=args.seed,
                    image_size=args.image_size)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
