"""The argparse surface of the port's CLIs, the argument groups of
`dimsum_tpu/cli.py` flag for flag, so the reference's shell scripts
translate as they are.

The port builds every DiM block type and scan type of the JAX package
(`--block-type`, `--bimamba-type`), with `--rms-norm` or LayerNorm,
`--cond-mamba` or plain Mamba, `--learn-sigma`, `--learnable-pe` or a fixed
sin-cos APE, `--use-final-norm`, `--not-use-gated-mlp`,
`--scanning-continuity` and `--enable-fourier-layers`.  A flag that asks
for something the port lacks (`--pe-type` rope or cpe, `--cond-init`, MoE,
DiT models) raises `NotImplementedError` naming its item in ROADMAP.md's
Queue 1; none is ignored.
"""

from __future__ import annotations

import argparse

import torch

BIMAMBA_CHOICES = ["v2", "none", "zigma_8", "sweep_8", "jpeg_8", "sweep_4",
                   "jpeg_2"]
BLOCK_CHOICES = ["linear", "raw", "wave", "combined", "window",
                 "combined_fourier", "combined_einfft"]

VARIANTS = "ROADMAP.md Queue 1 item 7 (model variants)"


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
    p.add_argument("--cond-init", action="store_true")
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
                   default=None)
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


def _require(ok: bool, flag: str, item: str = VARIANTS):
    if not ok:
        raise NotImplementedError(
            f"{flag}: not ported to dimsum_torch yet ({item})")


def model_config(args):
    """The port's `DiMConfig` for a CLI namespace (the JAX
    `models/factory.py::create_model`); raises `NotImplementedError` for
    what the port does not build."""
    from dimsum_torch.models.dim import DiM_models

    _require("DiM" in args.model and args.model in DiM_models,
             f"--model {args.model}", "ROADMAP.md Queue 1 item 7: "
             "DiT and models/factory.py")
    _require(args.pe_type == "ape", f"--pe-type {args.pe_type} "
             "(pe_extras.py, AdaInPosCNN)")
    _require(not args.cond_init, "--cond-init (the h0-seeded scan)")
    _require(not (args.is_moe or args.mamba_moe_layers), "MoE (--is-moe, "
             "--mamba-moe-layers; MoEBlock, SwitchMLP)")
    _require(args.scan_impl in (None, "ref"),
             f"--scan-impl {args.scan_impl}", "the port's scans are its "
             "CUDA kernels (None) and the plain PyTorch scan (ref)")
    return DiM_models[args.model](
        img_resolution=args.image_size // 8,
        in_channels=args.num_in_channels,
        label_dropout=args.label_dropout,
        num_classes=args.num_classes,
        use_attn_every_k_layers=args.use_attn_every_k_layers,
        drop_path=args.drop_path,
        block_type=args.block_type,
        scan_type=args.bimamba_type,
        rms_norm=args.rms_norm,
        cond_mamba=args.cond_mamba,
        learn_sigma=args.learn_sigma,
        learnable_pe=args.learnable_pe,
        use_final_norm=args.use_final_norm,
        use_gated_mlp=not args.not_use_gated_mlp,
        scanning_continuity=args.scanning_continuity,
        enable_fourier_layers=args.enable_fourier_layers,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        grad_checkpoint=args.grad_checkpoint,
        remat_policy=args.remat_policy)
