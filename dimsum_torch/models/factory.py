"""Model factory, port of `dimsum_tpu/models/factory.py`: a DiM or a DiT
from a CLI-style namespace (the flags of `dimsum_torch/cli.py`, which are
the JAX CLIs'), with the latent resolution image_size // 8.

`model_config` is the config half of the JAX `create_model` (the same
fields from the same flags), `build_model` builds a config's module with
seeded random weights, and `create_model` does both.  `--scan-impl
xla|pallas` raises `NotImplementedError` (the port's scans are its CUDA
kernels and the plain PyTorch scan).  The JAX package's opt-in
environment switches are read from the environment as the JAX package
reads them at call time, each setting the config field of its name: the
four of the fused-kernel configuration (`fused_switches`; a DiT takes only
`DIMSUM_FUSED_NORM`, the one of the four that reaches the JAX DiT, its
norm + modulate sites) and the six others (`env_switches`: the wavelet
packs, `DIMSUM_NORM_MXU` and the attention routes; a DiT takes the
norm and attention ones).  With --tp the CLI builds the model group and
sets `tp_group` on the config (with --is-moe, expert parallelism).
`--mamba-moe-layers` builds nothing, as in JAX: no module of
`dimsum_tpu/models` reads it.  A DiT
takes no DiM flag and no `--grad-checkpoint` from the namespace, as in
JAX (factory.py:53-62); `DiTConfig(grad_checkpoint=True)` remats it.
"""

from __future__ import annotations

import os
from typing import Any, Tuple, Union

import torch
import torch.nn as nn

from dimsum_torch.models.dim import DiM, DiM_models, DiMConfig, build_dim
from dimsum_torch.models.dit import DiT, DiT_models, DiTConfig, build_dit

ModelConfig = Union[DiMConfig, DiTConfig]

# the JAX package's other opt-in switches: "1" turns each boolean field on
# (blocks.py:385-416, norms.py:163-170); the attention's two are "1", "0"
# or anything else, "auto" (attention.py:35-54)
ENV_SWITCHES = {"DIMSUM_WAVELET_ONE_REARRANGE": "wavelet_one_rearrange",
                "DIMSUM_DWT_CL": "dwt_cl",
                "DIMSUM_FUSED_WAVELET": "fused_wavelet",
                "DIMSUM_NORM_MXU": "norm_mxu",
                "DIMSUM_FLASH_ATTN": "flash_attn",
                "DIMSUM_FULL_ATTN": "full_attn"}
_ATTN_SWITCHES = ("flash_attn", "full_attn")
# the JAX fused-kernel switches and the config fields they set
FUSED_SWITCHES = {"DIMSUM_PALLAS_NORM": "pallas_norm",
                  "DIMSUM_FUSED_NORM": "fused_norm",
                  "DIMSUM_CONV_XPROJ": "conv_xproj",
                  "DIMSUM_PENDING_TAIL": "pending_tail"}


def fused_switches(dit: bool = False) -> dict:
    """The config fields the JAX fused-kernel switches set, read from
    `os.environ` as the JAX package reads them: "1" turns
    `DIMSUM_PALLAS_NORM`, `DIMSUM_FUSED_NORM` and `DIMSUM_CONV_XPROJ` on
    (norms.py:153, :378; conv_xproj.py:54); `DIMSUM_PENDING_TAIL` is an
    integer, 0 where it is not one (blocks.py:100-111), and defers the
    tail above 0, through the norm + modulate kernel at 2 (dim.py:344-355).
    For a DiT (`dit`) only `fused_norm`: the JAX DiT has no add + norm,
    conv or deferred-tail site."""
    on = {field: os.environ.get(name, "0") == "1"
          for name, field in FUSED_SWITCHES.items()
          if field != "pending_tail"}
    if dit:
        return {"fused_norm": on["fused_norm"]}
    try:
        tail = int(os.environ.get("DIMSUM_PENDING_TAIL", "0"))
    except ValueError:
        tail = 0
    on["pending_tail"] = 2 if tail == 2 else int(tail > 0)
    return on


def env_switches(dit: bool = False) -> dict:
    """The config fields of the JAX opt-in switches besides the fused four,
    read from `os.environ` as the JAX package reads them: "1" turns
    `DIMSUM_WAVELET_ONE_REARRANGE`, `DIMSUM_DWT_CL`, `DIMSUM_FUSED_WAVELET`
    and `DIMSUM_NORM_MXU` on; `DIMSUM_FLASH_ATTN` and `DIMSUM_FULL_ATTN`
    are "1", "0" or "auto" (any other value).  For a DiT (`dit`) the norm
    and attention ones: the JAX DiT has no wavelet pack."""
    out = {}
    for name, field in ENV_SWITCHES.items():
        value = os.environ.get(name, "auto" if field in _ATTN_SWITCHES
                               else "0")
        if field in _ATTN_SWITCHES:
            out[field] = value if value in ("0", "1") else "auto"
        elif not dit or field == "norm_mxu":
            out[field] = value == "1"
    return out


def model_config(args: Any) -> ModelConfig:
    """The config the JAX `create_model` builds from `args`."""
    if args.scan_impl not in (None, "ref"):
        raise NotImplementedError(
            f"--scan-impl {args.scan_impl}: the port's scans are its CUDA "
            "kernels (None) and the plain PyTorch scan (ref)")
    dtype = torch.bfloat16 if getattr(args, "bf16", False) else torch.float32
    if "DiM" in args.model:
        return DiM_models[args.model](
            img_resolution=args.image_size // 8,
            in_channels=args.num_in_channels,
            label_dropout=args.label_dropout,
            num_classes=args.num_classes,
            gated_linear_unit=args.gated_linear_unit,
            routing_mode=args.routing_mode,
            num_moe_experts=args.num_moe_experts,
            is_moe=args.is_moe,
            learn_sigma=args.learn_sigma,
            scan_type=args.bimamba_type,
            pe_type=args.pe_type,
            block_type=args.block_type,
            cond_mamba=args.cond_mamba,
            use_cond_init=getattr(args, "cond_init", False),
            scanning_continuity=args.scanning_continuity,
            enable_fourier_layers=args.enable_fourier_layers,
            drop_path=args.drop_path,
            rms_norm=args.rms_norm,
            learnable_pe=args.learnable_pe,
            use_final_norm=args.use_final_norm,
            use_attn_every_k_layers=args.use_attn_every_k_layers,
            use_gated_mlp=not args.not_use_gated_mlp,
            dtype=dtype,
            grad_checkpoint=getattr(args, "grad_checkpoint", False),
            remat_policy=getattr(args, "remat_policy", None),
            **fused_switches(), **env_switches())
    if "DiT" in args.model:
        return DiT_models[args.model](
            img_resolution=args.image_size // 8,
            in_channels=args.num_in_channels,
            label_dropout=args.label_dropout,
            num_classes=args.num_classes,
            learn_sigma=args.learn_sigma,
            dtype=dtype,
            **fused_switches(dit=True), **env_switches(dit=True))
    raise ValueError(f"unknown model {args.model}")


def model_class(cfg: ModelConfig) -> type:
    return DiT if isinstance(cfg, DiTConfig) else DiM


def build_model(cfg: ModelConfig, device="cuda", seed: int = 0,
                train: bool = False) -> nn.Module:
    """`build_dim` or `build_dit`, by the config's type."""
    build = build_dit if isinstance(cfg, DiTConfig) else build_dim
    return build(cfg, device, seed=seed, train=train)


def create_model(args: Any, device="cuda", seed: int = 0,
                 train: bool = False) -> Tuple[nn.Module, ModelConfig]:
    """(module, config) for `args`, the JAX `create_model` on one device:
    the module on `device` with seeded random weights (`build_model`)."""
    cfg = model_config(args)
    return build_model(cfg, device, seed=seed, train=train), cfg
