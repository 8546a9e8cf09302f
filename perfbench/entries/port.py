"""The port under test, built as its CLIs build it: the configuration's
model through `dimsum_torch.models.factory.build_model`, then the
benchmark's weights loaded into it as a checkpoint is (`load_state_dict`,
strict), and the kernels built as the CLIs build them
(`ops.cuda_build.build`, into `build/dimsum_torch/` in the checkout)."""

from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_config(cfg: dict):
    """The port's config of the configuration file's `model` mapping."""
    from dimsum_torch.models.dim import DiM_models
    from dimsum_torch.models.dit import DiT_models

    dtype = DTYPES[cfg["compute_dtype"]]
    sw = cfg["switches"]
    common = dict(img_resolution=cfg["img_resolution"],
                  in_channels=cfg["in_channels"],
                  num_classes=cfg["num_classes"],
                  label_dropout=cfg["label_dropout"],
                  learn_sigma=cfg["learn_sigma"], dtype=dtype)
    if cfg["family"] == "dit":
        mc = DiT_models[cfg["zoo"]](fused_norm=sw.get("fused_norm", False),
                                    **common)
        shape = (mc.hidden_size, mc.depth, mc.patch_size, mc.num_heads)
    else:
        mc = DiM_models[cfg["zoo"]](
            use_attn_every_k_layers=cfg["use_attn_every_k_layers"],
            use_independent_attn=cfg["use_independent_attn"],
            drop_path=cfg["drop_path"], block_type=cfg["block_type"],
            scan_type=cfg["scan_type"], rms_norm=cfg["rms_norm"],
            cond_mamba=cfg["cond_mamba"], learnable_pe=cfg["learnable_pe"],
            pe_type=cfg["pe_type"], use_final_norm=cfg["use_final_norm"],
            use_gated_mlp=cfg["use_gated_mlp"],
            residual_in_fp32=cfg["residual_in_fp32"], **sw, **common)
        shape = (mc.hidden_size, mc.depth, mc.patch_size, cfg["num_heads"])
    want = (cfg["hidden_size"], cfg["depth"], cfg["patch_size"],
            cfg["num_heads"])
    if shape != want:
        raise ValueError(f"{cfg['zoo']} is {shape}, the file says {want}")
    return mc


def build(cfg: dict, weights: dict, device, train: bool = False):
    """The port's model of `cfg` on `device` holding `weights`."""
    from dimsum_torch.models.factory import build_model

    if torch.device(device).type == "cuda":
        from dimsum_torch.ops import cuda_build

        cuda_build.build()
    net = build_model(model_config(cfg), device, seed=0, train=train)
    net.load_state_dict(weights, strict=True)
    return net
