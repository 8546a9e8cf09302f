"""The plain DiT baseline (adaLN-Zero), port of `dimsum_tpu/models/dit.py`:
PatchEmbed -> a fixed sin-cos APE -> `depth` DiT blocks (timm's two-layer
MLP, not the gated one) -> FinalLayer -> unpatchify; the zoo of 12 sizes.

It reuses the DiM's modules: `DiTBlock(use_gated_mlp=False)`, whose
attention takes the full-block kernel at L >= 1024 (DiT-XL/2 at 512 px: Dh
72, `csrc/full_attention.cu`; DiT-L/2: Dh 64, the sm90 and fp32 kernels),
`PatchEmbed`, `TimestepEmbedder`, `LabelEmbedder` and `FinalLayer`; the
CFG wrappers of `models/dim.py` serve it as they serve the DiM.
`grad_checkpoint` recomputes each block in the backward with nothing kept
(the JAX `nn.remat`, dit.py:84-85), through `utils/remat.py`.
`fused_norm` (the JAX `DIMSUM_FUSED_NORM`) runs the blocks' two norms and
the FinalLayer's through the norm + modulate kernel; `norm_mxu`,
`flash_attn` and `full_attn` are the other JAX switches that reach a DiT
(`models/blocks.py::apply_switches`), and `tp_group` splits the
attentions' heads over a model group (timm's MLP stays whole, as under
the JAX rules).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn as nn

from dimsum_torch.models.blocks import DiTBlock, apply_switches
from dimsum_torch.models.embedders import (FinalLayer, LabelEmbedder,
                                           PatchEmbed, TimestepEmbedder,
                                           get_2d_sincos_pos_embed,
                                           unpatchify)
from dimsum_torch.models.linear import cast_weights_
from dimsum_torch.utils import remat
from dimsum_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    img_resolution: int = 32
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    label_dropout: float = 0.1
    num_classes: int = 1000
    learn_sigma: bool = False
    dtype: torch.dtype = torch.float32
    grad_checkpoint: bool = False  # remat each block, keeping nothing
    fused_norm: bool = False       # norm + modulate kernel at every norm
    norm_mxu: bool = False         # the JAX DIMSUM_NORM_MXU
    flash_attn: str = "auto"       # the JAX DIMSUM_FLASH_ATTN
    full_attn: str = "auto"        # the JAX DIMSUM_FULL_ATTN
    tp_group: Any = None           # the attentions' heads over a group

    @property
    def out_channels(self) -> int:
        return self.in_channels * 2 if self.learn_sigma else self.in_channels

    @property
    def grid_size(self) -> int:
        return self.img_resolution // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size ** 2


class DiT(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        D, dt = cfg.hidden_size, cfg.dtype
        self.x_embedder = PatchEmbed(cfg.patch_size, cfg.in_channels, D, dt)
        self.t_embedder = TimestepEmbedder(D, dtype=dt)
        self.y_embedder = LabelEmbedder(cfg.num_classes, D, cfg.label_dropout)
        self.pos_embed = nn.Parameter(
            torch.tensor(get_2d_sincos_pos_embed(D, cfg.grid_size))[None],
            requires_grad=False)
        self.blocks = nn.ModuleList([
            DiTBlock(D, cfg.num_heads, cfg.mlp_ratio, dtype=dt,
                     fused_norm=cfg.fused_norm, use_gated_mlp=False,
                     tp_group=cfg.tp_group)
            for _ in range(cfg.depth)])
        self.final_layer = FinalLayer(D, cfg.patch_size, cfg.out_channels,
                                      dt, fused_norm=cfg.fused_norm)
        apply_switches(self, cfg.norm_mxu, cfg.flash_attn, cfg.full_attn)

    def forward(self, x, t, y=None, train: bool = False,
                generator: torch.Generator | None = None,
                force_drop_ids=None):
        """As `DiM.forward`: x (N, C, H, W) latents, t (N,), y (N,) labels
        (None: the null class); `train` draws the label dropout from
        `generator`.  Returns (N, out_channels, H, W)."""
        cfg = self.cfg
        if y is None:
            y = torch.full((x.shape[0],),
                           self.y_embedder.embedding_table.num_embeddings - 1,
                           dtype=torch.long, device=x.device)
        y_emb = self.y_embedder(y, train=train, force_drop_ids=force_drop_ids,
                                generator=generator)
        c = (self.t_embedder(t) + y_emb).to(cfg.dtype)
        x = self.x_embedder(x.to(cfg.dtype)) + \
            self.pos_embed.detach().to(cfg.dtype)
        checkpointed = cfg.grad_checkpoint and torch.is_grad_enabled()
        for block in self.blocks:
            if checkpointed:
                x = remat.checkpoint(
                    lambda h, cc, generator=None, blk=block: blk(h, cc),
                    frozenset(), x, c)
            else:
                x = block(x, c)
        x = self.final_layer(x, c)
        return unpatchify(x.float(), cfg.patch_size, cfg.out_channels)


def _zoo(depth, hidden, patch, heads, **kw) -> DiTConfig:
    return DiTConfig(depth=depth, hidden_size=hidden, patch_size=patch,
                     num_heads=heads, **kw)


DiT_models = {
    "DiT-XL/2": lambda **kw: _zoo(28, 1152, 2, 16, **kw),
    "DiT-XL/4": lambda **kw: _zoo(28, 1152, 4, 16, **kw),
    "DiT-XL/8": lambda **kw: _zoo(28, 1152, 8, 16, **kw),
    "DiT-L/2": lambda **kw: _zoo(24, 1024, 2, 16, **kw),
    "DiT-L/4": lambda **kw: _zoo(24, 1024, 4, 16, **kw),
    "DiT-L/8": lambda **kw: _zoo(24, 1024, 8, 16, **kw),
    "DiT-B/2": lambda **kw: _zoo(12, 768, 2, 12, **kw),
    "DiT-B/4": lambda **kw: _zoo(12, 768, 4, 12, **kw),
    "DiT-B/8": lambda **kw: _zoo(12, 768, 8, 12, **kw),
    "DiT-S/2": lambda **kw: _zoo(12, 384, 2, 6, **kw),
    "DiT-S/4": lambda **kw: _zoo(12, 384, 4, 6, **kw),
    "DiT-S/8": lambda **kw: _zoo(12, 384, 8, 6, **kw),
}


def build_dit(cfg: DiTConfig, device="cuda", seed: int = 0,
              train: bool = False) -> DiT:
    """A DiT on `device` (CUDA unless the caller asks for the CPU) with
    seeded random weights (`dim.random_init_`'s rules), built as
    `build_dim` builds a DiM: for inference the Linear weights in
    cfg.dtype and eval mode, with `train=True` fp32 weights and train
    mode."""
    from dimsum_torch.models.dim import init_sharded_, random_init_

    dev = resolve_device(device)
    with torch.device(dev):
        model = DiT(cfg)
        if cfg.tp_group is None:
            random_init_(model, seed)
        else:
            init_sharded_(model, DiT(dataclasses.replace(cfg, tp_group=None)),
                          seed)
    if train:
        return model.train()
    return cast_weights_(model).eval()
