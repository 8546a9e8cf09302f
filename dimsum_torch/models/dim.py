"""DiM backbone, port of `dimsum_tpu/models/dim.py` for the published
configuration (block_type "combined", CondMamba, RMSNorm with an fp32
residual, sin-cos APE): PatchEmbed -> APE -> N combined blocks with a shared
16-head DiTBlock after every k-th block -> FinalLayer -> unpatchify.  Also
the CFG wrapper, the model zoo and a seeded random init.

Block i runs reverse = (i % 2 > 0) and transpose = (i % 4 >= 2), the
scan_type "none" schedule of the JAX `make_dim_block`, and stochastic depth
at inter_dpr[i], inter_dpr = [0] + linspace(0, drop_path, depth) (the JAX
`_drop_path_rates`, dim.py:270-277).  The JAX model's other drop-path site,
the final norm_f merge, exists only with `use_final_norm`, which the
published configuration leaves off, so the port has no norm_f.  The other block
types, scan types, position encodings and learn_sigma are not ported yet.

The JAX package's fused-kernel configuration is four `DiMConfig` fields named
after its switches, all off by default: `pallas_norm` (DIMSUM_PALLAS_NORM),
`fused_norm` (DIMSUM_FUSED_NORM), `conv_xproj` (DIMSUM_CONV_XPROJ) and
`pending_tail` (DIMSUM_PENDING_TAIL, 0, 1 or 2; the deferred tail is
materialized before each DiT block and at the end, dim.py:340-396).

`seq_group`, a `torch.distributed` process group (the JAX `seq_axis` with
its `seq_mesh`, dim.py:98-99, :189-191; `dimsum_torch.parallel.
make_seq_group` builds it), runs every mixer's conv and scan
sequence-parallel over its ranks, each in its own island (the mixer's
L-slice on each rank, the output gathered along L), while the rest of the
model runs whole on every rank: each rank passes the same inputs and gets
the same output.  It adds no parameters, so weights load as without it.
Forward only.

`grad_checkpoint` recomputes each combined block in the backward
(`torch.utils.checkpoint`, non-reentrant; the JAX `nn.remat`, dim.py:344-
353), keeping what `remat_policy` names: None (nothing), "dots", "scan",
"dots_scan" or "save:" over dots, scan_out, attn_out and conv_out (JAX
dim.py:91-97, :134-169).  The shared DiT block is not checkpointed, and the
pending tail is off under remat, as in JAX (dim.py:344).  How the kept
outputs of the port's kernels, the blocks' stochastic-depth draws and the
launch counts of each policy come out is in `dimsum_torch/utils/remat.py`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn as nn

from dimsum_torch.models.blocks import (DiMBlockCombined, DiTBlock, Norm,
                                       materialize_pending)
from dimsum_torch.models.embedders import (FinalLayer, LabelEmbedder,
                                           PatchEmbed, TimestepEmbedder,
                                           get_2d_sincos_pos_embed,
                                           unpatchify)
from dimsum_torch.models.linear import cast_weights_
from dimsum_torch.utils import remat
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
    drop_path: float = 0.0  # stochastic depth (scripts/train.sh: 0.1)
    dtype: torch.dtype = torch.float32
    pallas_norm: bool = False  # add + norm kernel at the blocks' top norm
    fused_norm: bool = False   # norm + modulate kernel at the other norms
    conv_xproj: bool = False   # conv + SiLU + x_proj kernel in every mixer
    pending_tail: int = 0      # 1, 2: defer each block's tail FFN add
    seq_group: Any = None      # sequence parallelism over a process group
    grad_checkpoint: bool = False  # remat each combined block
    remat_policy: Optional[str] = None  # what remat keeps (utils/remat.py)

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
        inter_dpr = [0.0] + np.linspace(0.0, cfg.drop_path,
                                        cfg.depth).tolist()
        if cfg.pending_tail not in (0, 1, 2):
            raise ValueError(f"pending_tail must be 0, 1 or 2, got "
                             f"{cfg.pending_tail}")
        self.remat_keep = (remat.parse_policy(cfg.remat_policy)
                           if cfg.grad_checkpoint else None)
        # the pending tuple would cross the checkpoint boundary
        self.pending_tail = 0 if cfg.grad_checkpoint else cfg.pending_tail
        self.blocks = nn.ModuleList([
            DiMBlockCombined(D, reverse=i % 2 > 0, transpose=i % 4 >= 2,
                             d_cond=D, drop_path_rate=inter_dpr[i], dtype=dt,
                             pallas_norm=cfg.pallas_norm,
                             fused_norm=cfg.fused_norm,
                             conv_xproj=cfg.conv_xproj,
                             pending_tail=self.pending_tail,
                             seq_group=cfg.seq_group)
            for i in range(cfg.depth)])
        if cfg.use_attn_every_k_layers > 0:
            self.attn_block = DiTBlock(D, 16, dtype=dt,
                                       fused_norm=cfg.fused_norm)
        self.final_layer = FinalLayer(D, cfg.patch_size, cfg.in_channels, dt,
                                      fused_norm=cfg.fused_norm)

    def forward(self, x, t, y=None, train: bool = False,
                generator: torch.Generator | None = None,
                force_drop_ids=None):
        """x: (N, C, H, W) latents; t: (N,) times in [0, 1]; y: (N,) labels
        (None: the null class).  `train` turns on label dropout and
        stochastic depth, drawn from `generator` (on x's device);
        `force_drop_ids` (N,), 1 = drop, replaces the label draw."""
        cfg = self.cfg
        if y is None:
            y = torch.full((x.shape[0],),
                           self.y_embedder.embedding_table.num_embeddings - 1,
                           dtype=torch.long, device=x.device)
        y_emb = self.y_embedder(y, train=train, force_drop_ids=force_drop_ids,
                                generator=generator)
        c = (self.t_embedder(t) + y_emb).to(cfg.dtype)
        x = self.x_embedder(x.to(cfg.dtype)) + self.pos_embed.to(cfg.dtype)
        residual = pending = None
        k = cfg.use_attn_every_k_layers
        checkpointed = (self.remat_keep is not None
                        and torch.is_grad_enabled())
        for i, block in enumerate(self.blocks):
            if checkpointed:
                x, residual = remat.checkpoint(
                    block, self.remat_keep, x, residual, c, train=train,
                    generator=generator)
            elif self.pending_tail > 0:
                x, residual, pending = block(x, residual, c, train=train,
                                             generator=generator,
                                             pending=pending)
            else:
                x, residual = block(x, residual, c, train=train,
                                    generator=generator)
            if k > 0 and (i + 1) % k == 0:
                x = materialize_pending(x, pending)
                pending = None
                x = self.attn_block(x, c)
        x = self.final_layer(materialize_pending(x, pending), c)
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


def forward_with_adacfg(model, x, t, y, cfg_scale: float = 3.8,
                        scale_pow: float = 4.0, in_channels: int = 4):
    """Classifier-free guidance with the power-cos scale on t: the guidance
    of each conditional row is 1 + (cfg_scale - 1)(1 - cos(pi (1 - t)^p))
    / 2, from that row's t (the JAX `forward_with_adacfg`)."""
    n = x.shape[0] // 2
    half = x[:n]
    out = model(torch.cat([half, half], dim=0), t, y)
    eps, rest = out[:, :in_channels], out[:, in_channels:]
    cond_eps, uncond_eps = eps.chunk(2, dim=0)
    scale_step = (1 - torch.cos(((1 - t) ** scale_pow) * math.pi)) * 0.5
    real_scale = ((cfg_scale - 1) * scale_step + 1)[:n].reshape(-1, 1, 1, 1)
    half_eps = uncond_eps + real_scale * (cond_eps - uncond_eps)
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


def build_dim(cfg: DiMConfig, device="cuda", seed: int = 0,
              train: bool = False) -> DiM:
    """A DiM on `device` (CUDA unless the caller asks for the CPU) with the
    seeded `random_init_` weights.  For inference (the default) the Linear
    weights are stored in cfg.dtype and the model is in eval mode; with
    `train=True` every parameter stays fp32 (the master weights the
    optimizer updates; `Linear` casts to cfg.dtype at each call, as the JAX
    package does) and the model is in train mode."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = DiM(cfg)
    random_init_(model, seed)
    if train:
        return model.train()
    return cast_weights_(model).eval()
