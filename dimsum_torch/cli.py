"""The argparse surface of the port's CLIs, the argument groups of
`dimsum_tpu/cli.py` flag for flag, so the reference's shell scripts
translate as they are.

`dimsum_torch/models/factory.py::model_config` maps a namespace of these
flags to a model config as the JAX `create_model` does: every DiM and DiT
of the JAX zoos, every block and scan type, MoE (`--is-moe` and its
group), `--pe-type`, `--cond-init`.  What the port lacks raises
`NotImplementedError` naming its item in ROADMAP.md's Queue 1 (the
factory's, and the CLIs' multi-device flags); `--mamba-moe-layers` builds
nothing, as in JAX.
"""

from __future__ import annotations

import argparse

# the JAX `create_model`, under the name the CLIs have imported it by
from dimsum_torch.models.factory import (create_model,  # noqa: F401
                                         model_config)

BIMAMBA_CHOICES = ["v2", "none", "zigma_8", "sweep_8", "jpeg_8", "sweep_4",
                   "jpeg_2"]
BLOCK_CHOICES = ["linear", "raw", "wave", "combined", "window",
                 "combined_fourier", "combined_einfft"]


def none_or_str(value):
    if value == "None":
        return None
    return value


def add_model_args(p: argparse.ArgumentParser):
    p.add_argument("--model", type=str, default="DiM-L/2")
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--num-in-channels", type=int, default=4)
    p.add_argument("--num-classes", type=int, default=0)
    p.add_argument("--label-dropout", type=float, default=-1)
    p.add_argument("--learn-sigma", action="store_true")
    p.add_argument("--bimamba-type", type=str, default="v2",
                   choices=BIMAMBA_CHOICES)
    p.add_argument("--cond-mamba", action="store_true")
    p.add_argument("--cond-init", action="store_true",
                   help="seed the scan state with cond_proj(c)")
    p.add_argument("--scanning-continuity", action="store_true")
    p.add_argument("--enable-fourier-layers", action="store_true")
    p.add_argument("--rms-norm", action="store_true")
    p.add_argument("--fused-add-norm", action="store_true")
    p.add_argument("--drop-path", type=float, default=0.0)
    p.add_argument("--use-final-norm", action="store_true")
    p.add_argument("--use-attn-every-k-layers", type=int, default=-1)
    p.add_argument("--block-type", type=str, default="linear",
                   choices=BLOCK_CHOICES)
    p.add_argument("--not-use-gated-mlp", action="store_true")
    p.add_argument("--pe-type", type=str, default="ape",
                   choices=["ape", "cpe", "rope"])
    p.add_argument("--learnable-pe", action="store_true")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (the model's dtype)")
    p.add_argument("--scan-impl", type=none_or_str, default=None,
                   choices=[None, "ref", "xla", "pallas"],
                   help="None: the CUDA kernels on the card; ref: the plain "
                        "PyTorch scan")
    p.add_argument("--grad-checkpoint", action="store_true")
    p.add_argument("--remat-policy", type=str, default=None,
                   choices=[None, "none", "dots", "scan", "dots_scan"])


def add_moe_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("MoE arguments")
    g.add_argument("--num-moe-experts", type=int, default=8)
    g.add_argument("--mamba-moe-layers", type=none_or_str, nargs="*",
                   default=None,
                   help="accepted as the JAX CLIs accept it; no model reads "
                        "it, so it builds nothing")
    g.add_argument("--is-moe", action="store_true")
    g.add_argument("--routing-mode", type=str, default="top1",
                   choices=["sinkhorn", "top1", "top2", "sinkhorn_top2"])
    g.add_argument("--gated-linear-unit", action="store_true")


def add_transport_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("Transport arguments")
    g.add_argument("--path-type", type=str, default="Linear",
                   choices=["Linear", "GVP", "VP"])
    g.add_argument("--prediction", type=str, default="velocity",
                   choices=["velocity", "score", "noise"])
    g.add_argument("--loss-weight", type=none_or_str, default=None,
                   choices=[None, "velocity", "likelihood"])
    g.add_argument("--sample-eps", type=float)
    g.add_argument("--train-eps", type=float)
    g.add_argument("--diffusion-form", type=str, default="none",
                   choices=["none", "constant", "SBDM", "sigma", "linear",
                            "decreasing", "increasing-decreasing", "log"])
    g.add_argument("--t-sample-mode", type=str, default="uniform")
    g.add_argument("--use-blurring", action="store_true")
    g.add_argument("--blur-sigma-max", type=int, default=3)
    g.add_argument("--blur-upscale", type=int, default=4)


def add_ode_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("ODE arguments")
    g.add_argument("--sampling-method", type=str, default="dopri5",
                   choices=["dopri5", "euler", "heun"])
    g.add_argument("--atol", type=float, default=1e-6)
    g.add_argument("--rtol", type=float, default=1e-3)
    g.add_argument("--reverse", action="store_true")
    g.add_argument("--likelihood", action="store_true")


def add_sde_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("SDE arguments")
    g.add_argument("--sampling-method", type=str, default="Euler",
                   choices=["Euler", "Heun"])
    g.add_argument("--diffusion-norm", type=float, default=1.0)
    g.add_argument("--last-step", type=none_or_str, default="Mean",
                   choices=[None, "Mean", "Tweedie", "Euler"])
    g.add_argument("--last-step-size", type=float, default=0.04)


def add_vae_args(p: argparse.ArgumentParser):
    p.add_argument("--vae", type=str, choices=["ema", "mse"], default="ema")
    p.add_argument("--vae-ckpt", type=str, default=None,
                   help="local diffusers VAE weights (.bin/.pt; "
                        ".safetensors needs the safetensors package), or "
                        "random[:seed]; without it the latents are saved")


def build_transport(args):
    from dimsum_torch.transport import create_transport

    path_args = {}
    if getattr(args, "use_blurring", False):
        path_args = dict(use_blurring=True,
                         blur_sigma_max=args.blur_sigma_max,
                         blur_upscale=args.blur_upscale)
    return create_transport(
        args.path_type, args.prediction, args.loss_weight, args.train_eps,
        args.sample_eps, path_args,
        t_sample_mode=getattr(args, "t_sample_mode", "uniform"))


def _require(ok: bool, flag: str, item: str):
    """Raise `NotImplementedError` for a flag the port does not take yet,
    naming its ROADMAP item."""
    if not ok:
        raise NotImplementedError(
            f"{flag}: not ported to dimsum_torch yet ({item})")
