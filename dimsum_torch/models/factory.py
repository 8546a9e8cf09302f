"""Model factory, port of `dimsum_tpu/models/factory.py`: a DiM or a DiT
from a CLI-style namespace (the flags of `dimsum_torch/cli.py`, which are
the JAX CLIs'), with the latent resolution image_size // 8.

`model_config` is the config half of the JAX `create_model` (the same
fields from the same flags), `build_model` builds a config's module with
seeded random weights, and `create_model` does both.  What the port does
not build raises `NotImplementedError` naming its ROADMAP item:
`--scan-impl xla|pallas` (the port's scans are its CUDA kernels and the
plain PyTorch scan), MoE with tensor parallelism (the JAX `ep_mesh`,
expert parallelism: Queue 1 item 8) and the JAX opt-in environment
switches the port lacks (`UNPORTED_SWITCHES`, item 7).  The four switches
of the JAX fused-kernel configuration are read from the environment as
the JAX package reads them at call time (`fused_switches`): each sets
the config field of its name, and a DiT takes only `DIMSUM_FUSED_NORM`,
the one of the four that reaches the JAX DiT (its norm + modulate sites).
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

# the JAX package's opt-in environment switches that the port has not
# ported (ROADMAP Queue 1 item 7); set to "1" they are refused, not ignored
UNPORTED_SWITCHES = ("DIMSUM_WAVELET_ONE_REARRANGE", "DIMSUM_DWT_CL",
                     "DIMSUM_FUSED_WAVELET", "DIMSUM_NORM_MXU",
                     "DIMSUM_FLASH_ATTN", "DIMSUM_FULL_ATTN")
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


def model_config(args: Any) -> ModelConfig:
    """The config the JAX `create_model` builds from `args`."""
    for name in UNPORTED_SWITCHES:
        if os.environ.get(name, "0") == "1":
            raise NotImplementedError(
                f"{name}=1: the JAX opt-in switch is not ported to "
                "dimsum_torch yet (ROADMAP.md Queue 1 item 7)")
    if args.scan_impl not in (None, "ref"):
        raise NotImplementedError(
            f"--scan-impl {args.scan_impl}: the port's scans are its CUDA "
            "kernels (None) and the plain PyTorch scan (ref)")
    if getattr(args, "tp", 1) > 1 and args.is_moe:
        raise NotImplementedError(
            "--is-moe with --tp (experts sharded over the model axis, the "
            "JAX parallel/moe_ep.py): not ported to dimsum_torch yet "
            "(ROADMAP.md Queue 1 item 8)")
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
            **fused_switches())
    if "DiT" in args.model:
        return DiT_models[args.model](
            img_resolution=args.image_size // 8,
            in_channels=args.num_in_channels,
            label_dropout=args.label_dropout,
            num_classes=args.num_classes,
            learn_sigma=args.learn_sigma,
            dtype=dtype,
            **fused_switches(dit=True))
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
