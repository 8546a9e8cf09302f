"""DiM backbone, port of `dimsum_tpu/models/dim.py` for the published
configuration (block_type "combined", CondMamba, RMSNorm with an fp32
residual, sin-cos APE): PatchEmbed -> APE -> N combined blocks with a shared
16-head DiTBlock after every k-th block -> FinalLayer -> unpatchify.  Also
the CFG wrapper, the model zoo and a seeded random init.

Block i runs reverse = (i % 2 > 0) and transpose = (i % 4 >= 2), the
scan_type "none" schedule of the JAX `make_dim_block`.  The other block
types, scan types, position encodings and learn_sigma are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn

from dimsum_torch.models.blocks import DiMBlockCombined, DiTBlock, Norm
from dimsum_torch.models.embedders import (FinalLayer, LabelEmbedder,
                                           PatchEmbed, TimestepEmbedder,
                                           get_2d_sincos_pos_embed,
                                           unpatchify)
from dimsum_torch.models.linear import cast_weights_
from dimsum_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DiMConfig:
    img_resolution: int = 32
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 1024
    depth: int = 16
    label_dropout: float = 0.1  # > 0: the label table has a null class
    num_classes: int = 1000
    use_attn_every_k_layers: int = 4
    dtype: torch.dtype = torch.float32

    @property
    def grid_size(self) -> int:
        return self.img_resolution // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size ** 2


class DiM(nn.Module):
    def __init__(self, cfg: DiMConfig):
        super().__init__()
        self.cfg = cfg
        D, dt = cfg.hidden_size, cfg.dtype
        self.x_embedder = PatchEmbed(cfg.patch_size, cfg.in_channels, D, dt)
        self.t_embedder = TimestepEmbedder(D, dtype=dt)
        self.y_embedder = LabelEmbedder(cfg.num_classes, D, cfg.label_dropout)
        self.pos_embed = nn.Parameter(
            torch.tensor(get_2d_sincos_pos_embed(D, cfg.grid_size))[None])
        self.blocks = nn.ModuleList([
            DiMBlockCombined(D, reverse=i % 2 > 0, transpose=i % 4 >= 2,
                             d_cond=D, dtype=dt)
            for i in range(cfg.depth)])
        if cfg.use_attn_every_k_layers > 0:
            self.attn_block = DiTBlock(D, 16, dtype=dt)
        self.final_layer = FinalLayer(D, cfg.patch_size, cfg.in_channels, dt)

    def forward(self, x, t, y=None):
        """x: (N, C, H, W) latents; t: (N,) times in [0, 1]; y: (N,) labels
        (None: the null class)."""
        cfg = self.cfg
        if y is None:
            y = torch.full((x.shape[0],),
                           self.y_embedder.embedding_table.num_embeddings - 1,
                           dtype=torch.long, device=x.device)
        c = (self.t_embedder(t) + self.y_embedder(y)).to(cfg.dtype)
        x = self.x_embedder(x.to(cfg.dtype)) + self.pos_embed.to(cfg.dtype)
        residual = None
        k = cfg.use_attn_every_k_layers
        for i, block in enumerate(self.blocks):
            x, residual = block(x, residual, c)
            if k > 0 and (i + 1) % k == 0:
                x = self.attn_block(x, c)
        x = self.final_layer(x, c)
        return unpatchify(x.float(), cfg.patch_size, cfg.in_channels)


def forward_with_cfg(model, x, t, y, cfg_scale: float = 1.0,
                     in_channels: int = 4):
    """Classifier-free guidance on a doubled batch: x is [half; half], y is
    [labels; null].  Guidance applies to the first `in_channels` output
    channels only."""
    half = x[: x.shape[0] // 2]
    out = model(torch.cat([half, half], dim=0), t, y)
    eps, rest = out[:, :in_channels], out[:, in_channels:]
    cond_eps, uncond_eps = eps.chunk(2, dim=0)
    half_eps = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
    return torch.cat([torch.cat([half_eps, half_eps], dim=0), rest], dim=1)


def _zoo_cfg(depth, hidden, patch, **kw) -> DiMConfig:
    return DiMConfig(depth=depth, hidden_size=hidden, patch_size=patch, **kw)


DiM_models = {
    "DiM-XL/2": lambda **kw: _zoo_cfg(24, 1152, 2, **kw),
    "DiM-L/2": lambda **kw: _zoo_cfg(16, 1024, 2, **kw),
    "DiM-L/2-v1": lambda **kw: _zoo_cfg(20, 1024, 2, **kw),
    "DiM-B/2": lambda **kw: _zoo_cfg(12, 768, 2, **kw),
    "DiM-L/4": lambda **kw: _zoo_cfg(16, 1024, 4, **kw),
    "DiM-L/4-v1": lambda **kw: _zoo_cfg(20, 1024, 4, **kw),
    "DiM-S/2": lambda **kw: _zoo_cfg(4, 256, 2, **kw),
    "DiM-S8/2": lambda **kw: _zoo_cfg(8, 256, 2, **kw),
}


@torch.no_grad()
def random_init_(model: DiM, seed: int) -> DiM:
    """Seeded random weights for runs without a checkpoint.  Every Linear
    and conv draws U(+-1/sqrt(fan_in)) (including the adaLN and final
    layers the JAX init zeroes, so every branch contributes), biases 0,
    the label table N(0, 0.02); the Mamba A_log, D and dt_proj.bias keep
    the Mamba init (dt log-uniform in [1e-3, 0.1] through the inverse
    softplus); norm weights 1; pos_embed the sin-cos table."""
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    keep = {id(p) for m in model.modules() if isinstance(m, Norm)
            for p in m.parameters()} | {id(model.pos_embed)}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if id(p) in keep:
            continue  # the constructor's ones / zeros / sin-cos table
        if leaf == "A_log":
            n = p.shape[1]
            p.copy_(torch.log(torch.arange(1, n + 1, device=dev,
                                           dtype=p.dtype)).expand_as(p))
        elif leaf == "D":
            p.fill_(1.0)
        elif name.endswith("dt_proj.bias"):
            u = torch.rand(p.shape, generator=g, device=dev)
            dt = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                           + math.log(1e-3)).clamp_min(1e-4)
            p.copy_(dt + torch.log(-torch.expm1(-dt)))
        elif name.endswith("embedding_table.weight"):
            p.normal_(0.0, 0.02, generator=g)
        elif leaf == "bias":
            p.zero_()
        else:
            bound = 1.0 / math.sqrt(p[0].numel())
            p.uniform_(-bound, bound, generator=g)
    return model


def build_dim(cfg: DiMConfig, device="cuda", seed: int = 0) -> DiM:
    """A DiM on `device` (CUDA unless the caller asks for the CPU) with the
    seeded `random_init_` weights, Linear weights stored in cfg.dtype."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = DiM(cfg)
    random_init_(model, seed)
    return cast_weights_(model).eval()
