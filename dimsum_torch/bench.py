"""Sampling benchmark of the port: the protocol of the JAX package's
`bench.py` on PyTorch/CUDA.

DiM-L/2 "combined" at 256 px (latent 32x32, patch 2, L = 256 tokens) or,
with `--image-size 512`, at 512 px (latent 64x64, L = 1024 tokens, where
the attention takes the full-block kernel and the frequency half the
dwt_tokens + local_scan route): hidden 1024, depth 16, CondMamba, RMSNorm
with an fp32 residual, learnable sin-cos APE, a shared 16-head DiTBlock
after every 4th block, seeded random weights (no checkpoint ships with the
repo), CFG 1.4 on a doubled batch, GVP velocity transport, Euler over 250
grid points, or with `--solver dopri5` the reference's adaptive solver
(atol 1e-6, rtol 1e-3), whose NFE the record reports.  One untimed warm-up
drift call precedes the timed run.

`--model` takes another entry of the DiM zoo or of the DiT zoo (`DiT-XL/2`
at 512 px: Dh 72, the full-block attention's first kernel); a DiT takes
only `--fused-norm` of the switches below.  `--bf16-residual` is the JAX
bench's probe (bench.py:55-59, :87): the DiM's residual stream carried in
the compute dtype (`residual_in_fp32=False`), through the add + norm and
norm + modulate kernels' bf16-residual case where their switches are on.

The JAX package's fused-kernel configuration runs with its four switches as
flags: `--pallas-norm` (the add + norm kernel), `--fused-norm` (the norm +
modulate kernel), `--conv-xproj` (the conv + SiLU + x_proj kernel) and
`--pending-tail 1|2` (each block's tail FFN add deferred into the next
block's top norm), or as the JAX environment switches `DIMSUM_PALLAS_NORM`,
`DIMSUM_FUSED_NORM`, `DIMSUM_CONV_XPROJ` and `DIMSUM_PENDING_TAIL`, which
every CLI of the port reads (`models/factory.py::fused_switches`).

    python -m dimsum_torch.bench --batch 12 --steps 250 --dtype bf16 \
        --cfg 1.4 --device cuda [--image-size 512] [--solver dopri5] \
        [--pallas-norm --fused-norm --conv-xproj --pending-tail 2]

Prints one JSON line: images per second on this card, with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from dimsum_torch.models.dim import DiM_models, forward_with_cfg
from dimsum_torch.models.dit import DiT_models
from dimsum_torch.models.factory import build_model, fused_switches
from dimsum_torch.transport import Sampler, create_transport
from dimsum_torch.utils.device import card_name_and_power_limit, resolve_device

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
IMAGE_SIZES = (256, 512)  # pixels; the latent is a size / 8 square
SOLVERS = ("euler", "dopri5")
# the DiMConfig fields of the fused-kernel configuration, all off by default
FUSED_DEFAULTS = dict(pallas_norm=False, fused_norm=False, conv_xproj=False,
                      pending_tail=0)


def add_fused_flags(ap: argparse.ArgumentParser) -> None:
    """The four switches of the fused-kernel configuration as flags."""
    ap.add_argument("--pallas-norm", action="store_true",
                    help="add + norm kernel at each block's top norm")
    ap.add_argument("--fused-norm", action="store_true",
                    help="norm + modulate kernel at the other norms")
    ap.add_argument("--conv-xproj", action="store_true",
                    help="conv + SiLU + x_proj kernel in every mixer")
    ap.add_argument("--pending-tail", type=int, default=0, choices=(0, 1, 2),
                    help="defer each block's tail FFN add into the next "
                         "top norm (2: through the norm + modulate kernel)")


def fused_settings(args: argparse.Namespace, dit: bool = False) -> dict:
    """The four switches from the flags and the environment: a switch is
    on where its flag or its JAX environment switch turns it on
    (`factory.fused_switches`, which the other CLIs build by), so a flag
    and its `DIMSUM_*` variable set the same field; a `--pending-tail`
    above 0 wins over the variable.  For a DiT (`dit`) the environment
    gives only `fused_norm`, as in the factory."""
    env = fused_switches(dit)
    return {k: getattr(args, k) or env.get(k, FUSED_DEFAULTS[k])
            for k in FUSED_DEFAULTS}


def fused_config(**fused) -> dict:
    """All four switches, each given or at its default; raises on a name
    that is not one of them."""
    unknown = set(fused) - set(FUSED_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown switches {sorted(unknown)}")
    return {**FUSED_DEFAULTS, **fused}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(batch: int = 12, steps: int = 250, dtype: str = "bf16",
        cfg_scale: float = 1.4, device="cuda", seed: int = 0,
        model: str = "DiM-L/2", image_size: int = 256,
        solver: str = "euler", residual_in_fp32: bool = True, **fused):
    """Build the model (`model` names a zoo entry: DiM-L/2, or a narrower
    one for a rehearsal on the CPU, or a DiT) at `image_size` pixels, with the
    fused-kernel switches `fused` (pallas_norm, fused_norm, conv_xproj,
    pending_tail; off by default) and the residual stream in fp32 or (not
    `residual_in_fp32`) in the compute dtype, sample once untimed for one
    drift call,
    then time one full sample by `solver` (Euler over `steps` grid points,
    or dopri5, whose NFE goes into the record).  Returns (record, samples
    of the conditional half)."""
    if image_size not in IMAGE_SIZES:
        raise ValueError(f"image_size must be one of {IMAGE_SIZES}")
    if solver not in SOLVERS:
        raise ValueError(f"solver must be one of {SOLVERS}")
    dev = resolve_device(device)
    latent = image_size // 8
    fused = fused_config(**fused)
    if model in DiT_models:
        if any(v for k, v in fused.items() if k != "fused_norm"):
            raise ValueError("a DiT takes only the fused_norm switch")
        if not residual_in_fp32:
            raise ValueError("a DiT has no residual stream to carry in bf16")
        cfg = DiT_models[model](img_resolution=latent, num_classes=1000,
                                dtype=DTYPES[dtype],
                                fused_norm=fused["fused_norm"])
    else:
        cfg = DiM_models[model](img_resolution=latent, num_classes=1000,
                                use_attn_every_k_layers=4,
                                dtype=DTYPES[dtype],
                                residual_in_fp32=residual_in_fp32, **fused)
    net = build_model(cfg, dev, seed)
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
        out = sampler.sample_ode(sampling_method=solver, num_steps=steps,
                                 return_nfe=solver == "dopri5")(
            z, model_fn, y=y)
        _sync(dev)
        seconds = time.perf_counter() - t0
    nfe = None
    if solver == "dopri5":
        out, nfe = out
    record = {
        "metric": f"imagenet{image_size}_sampling_throughput_"
                  + (f"{steps}step" if solver == "euler" else "dopri5")
                  + "_cfg",
        "value": batch / seconds,
        "unit": "img/s",
        "seconds": seconds,
        "batch": batch,
        "steps": steps if solver == "euler" else None,
        "solver": solver,
        "nfe": nfe,
        "model": model,
        "image_size": image_size,
        "dtype": dtype,
        "cfg_scale": cfg_scale,
        "fused": fused,
        "residual_in_fp32": residual_in_fp32,
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
    ap.add_argument("--solver", default="euler", choices=SOLVERS,
                    help="euler: a fixed grid of --steps points; dopri5: "
                         "the reference's adaptive solver, NFE reported")
    ap.add_argument("--model", default="DiM-L/2",
                    choices=sorted(DiM_models) + sorted(DiT_models))
    ap.add_argument("--bf16-residual", action="store_true",
                    help="carry the residual stream in the compute dtype "
                         "instead of fp32 (the JAX bench's probe)")
    add_fused_flags(ap)
    args = ap.parse_args(argv)
    record, _ = run(batch=args.batch, steps=args.steps, dtype=args.dtype,
                    cfg_scale=args.cfg, device=args.device, seed=args.seed,
                    model=args.model, image_size=args.image_size,
                    solver=args.solver,
                    residual_in_fp32=not args.bf16_residual,
                    **fused_settings(args, dit=args.model in DiT_models))
    print(json.dumps(record))


if __name__ == "__main__":
    main()
