"""DiM backbone, port of `dimsum_tpu/models/dim.py`: PatchEmbed -> APE
-> N blocks (with a DiTBlock after every k-th, shared or independent, and
optional auxiliary wavelet blocks) -> optional norm_f -> FinalLayer ->
unpatchify.  Also the CFG wrappers, the model zoo and a seeded random
init.

`DiMConfig` carries the JAX config's structural fields (dim.py:54-103):
`block_type` ("linear", "raw" (depth tripled), "wave", "window",
"combined", "combined_fourier", "combined_einfft"), `scan_type` ("none",
"v2", or a zigzag "<zoo>_<n>" with the layers' paths from
`ops/scan_orders.py`), `rms_norm` (else LayerNorm), `cond_mamba` (else
plain Mamba), `learn_sigma` (out_channels twice in_channels),
`learnable_pe` (else the sin-cos table takes no gradient),
`use_final_norm`, `use_independent_attn`, `use_gated_mlp`,
`scanning_continuity` and `enable_fourier_layers`; `pe_type` ("ape", the
sin-cos table; "rope", the 2-D rotary tables applied once after the patch
embedding; "cpe", `AdaInPosCNN`, dim.py:304-321; only "ape" has a
`pos_embed`), `use_cond_init` (every main block's CondMamba seeds its scans
from cond_proj(c), `models/mamba.py`) and the MoE group: `is_moe` makes
every odd block a `MoEBlock` (add + norm, then the routed `SwitchMLP`
with `num_moe_experts`, `routing_mode`, `gated_linear_unit`,
`add_bias_linear`; `moe_capacity_factor` is the expert-parallel
dispatch's, taken with `tp_group`).  `residual_in_fp32` (the JAX field;
False is the JAX bench's --bf16-residual) carries the residual stream in
the compute dtype: each block's top norm rounds the new residual once, the
kernels read and write it so (dim.py:64, :218, :233).  The
port's defaults are the published configuration (combined, CondMamba,
RMSNorm, a learnable APE, a DiT block after every 4th block); the CLIs
(`models/factory.py::model_config`) set every field from the JAX flags.
`make_dim_block` is the JAX block dispatch (dim.py:208-263): with
`is_moe` every odd block is a MoEBlock (the block indices, and so the DiT
blocks' places, stay JAX's); with scan_type "none" block i runs reverse
= (i % 2 > 0) and transpose = (i % 4 >= 2) (the window block: transpose
= reverse); other scan types neither.  Stochastic depth
runs at inter_dpr[i], inter_dpr = [0] + linspace(0, drop_path, eff_depth),
the auxiliary blocks at dpr[i], and the norm_f merge at the full rate
(the JAX `_drop_path_rates`, dim.py:270-277, and :398-407).

The JAX package's fused-kernel configuration is four `DiMConfig` fields named
after its switches, all off by default: `pallas_norm` (DIMSUM_PALLAS_NORM),
`fused_norm` (DIMSUM_FUSED_NORM), `conv_xproj` (DIMSUM_CONV_XPROJ) and
`pending_tail` (DIMSUM_PENDING_TAIL, 0, 1 or 2; combined blocks only, the
deferred tail materialized before every other block, each auxiliary
block, each DiT block and at the end, dim.py:340-396).  The JAX
`DIMSUM_NATIVE_REVERSE` has no field: a reversed block runs its reverse
inside its mixer whenever nothing needs a gradient (`models/blocks.py`).

`seq_group`, a `torch.distributed` process group (the JAX `seq_axis` with
its `seq_mesh`, dim.py:98-99, :189-191; `dimsum_torch.parallel.
make_seq_group` builds it), runs every mixer's conv and scan
sequence-parallel over its ranks, each in its own island (the mixer's
L-slice on each rank, the output gathered along L), while the rest of the
model runs whole on every rank: each rank passes the same inputs and gets
the same output.  It adds no parameters, so weights load as without it.
Forward only.

The JAX package's other opt-in environment switches are fields too, read
by `models/factory.py::env_switches` for every CLI: `norm_mxu`
(DIMSUM_NORM_MXU), `flash_attn` and `full_attn` (DIMSUM_FLASH_ATTN,
DIMSUM_FULL_ATTN: "1", "0" or "auto"), `dwt_cl`, `fused_wavelet` and
`wavelet_one_rearrange` (DIMSUM_DWT_CL, DIMSUM_FUSED_WAVELET,
DIMSUM_WAVELET_ONE_REARRANGE); `blocks.apply_switches` sets them on the
modules they reach.

`tp_group`, the model group of `parallel.make_mesh_groups` (the JAX
`--tp` mesh's model axis with `tp_param_specs`), holds each rank's shard
of the parameters that `parallel/mesh.py::TP_RULES` names (the mixers, the
gated MLPs, the attentions' heads) and, with `is_moe`, its experts
(expert parallelism with capacity dispatch); every rank of the group takes
the same inputs and returns the same output.  `build_dim` draws the full
model's weights and keeps the rank's shards, so a TP model holds the
unsharded model's weights.

`grad_checkpoint` recomputes each main block in the backward
(`torch.utils.checkpoint`, non-reentrant; the JAX `nn.remat`, dim.py:344-
353), keeping what `remat_policy` names: None (nothing), "dots", "scan",
"dots_scan" or "save:" over dots, scan_out, attn_out and conv_out (JAX
dim.py:91-97, :134-169).  The DiT and auxiliary blocks are not
checkpointed, and the pending tail is off under remat, as in JAX
(dim.py:344).  How the kept outputs of the port's kernels, the blocks'
stochastic-depth draws and the launch counts of each policy come out is in
`dimsum_torch/utils/remat.py`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn as nn

from dimsum_torch.models.blocks import (DiMBlockCombined, DiMBlockWindow,
                                       DiTBlock, MixerBlockCore, MoEBlock,
                                       Norm, WaveDiMBlock, apply_switches,
                                       drop_path_fn, materialize_pending)
from dimsum_torch.models.embedders import (AdaInPosCNN, FinalLayer,
                                           LabelEmbedder, PatchEmbed,
                                           TimestepEmbedder, apply_rotary,
                                           get_2d_sincos_pos_embed,
                                           get_2d_sincos_rotary_embed,
                                           unpatchify)
from dimsum_torch.models.linear import cast_weights_
from dimsum_torch.models.mamba import is_zigzag
from dimsum_torch.ops.scan_orders import build_layer_paths
from dimsum_torch.utils import remat
from dimsum_torch.utils.device import resolve_device

BLOCK_TYPES = ("linear", "raw", "wave", "window", "combined",
               "combined_fourier", "combined_einfft")
PE_TYPES = ("ape", "rope", "cpe")


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
    block_type: str = "combined"  # one of BLOCK_TYPES
    scan_type: str = "none"       # "none" | "v2" | "<zoo>_<n>"
    rms_norm: bool = True         # False: LayerNorm (weight and bias)
    cond_mamba: bool = True       # False: plain Mamba (no cond_proj)
    learn_sigma: bool = False
    learnable_pe: bool = True     # False: the sin-cos APE takes no gradient
    use_final_norm: bool = False
    use_independent_attn: bool = False
    use_gated_mlp: bool = True
    scanning_continuity: bool = False
    enable_fourier_layers: bool = False
    pe_type: str = "ape"          # one of PE_TYPES
    use_cond_init: bool = False   # seed the scans from cond_proj(c)
    is_moe: bool = False          # every odd block a MoEBlock
    num_moe_experts: int = 8
    routing_mode: str = "top1"    # "top1": softmax; "sinkhorn": sigmoid
    gated_linear_unit: bool = True
    add_bias_linear: bool = False
    moe_capacity_factor: float = 2.0  # the EP dispatch's (with tp_group)
    residual_in_fp32: bool = True  # False: the residual stream in dtype
    norm_mxu: bool = False     # norm reductions as ones-column products
    flash_attn: str = "auto"   # DIMSUM_FLASH_ATTN: "1", "0" or "auto"
    full_attn: str = "auto"    # DIMSUM_FULL_ATTN: "1", "0" or "auto"
    dwt_cl: bool = False       # the channel-last wavelet pack
    fused_wavelet: bool = False  # the basis wavelet pack
    wavelet_one_rearrange: bool = False  # one rearrange at 512 px too
    tp_group: Any = None       # tensor (and expert) parallelism
    pallas_norm: bool = False  # add + norm kernel at the blocks' top norm
    fused_norm: bool = False   # norm + modulate kernel at the other norms
    conv_xproj: bool = False   # conv + SiLU + x_proj kernel in every mixer
    pending_tail: int = 0      # 1, 2: defer each block's tail FFN add
    seq_group: Any = None      # sequence parallelism over a process group
    grad_checkpoint: bool = False  # remat each main block
    remat_policy: Optional[str] = None  # what remat keeps (utils/remat.py)

    @property
    def grid_size(self) -> int:
        return self.img_resolution // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size ** 2

    @property
    def out_channels(self) -> int:
        return self.in_channels * 2 if self.learn_sigma else self.in_channels

    @property
    def eff_depth(self) -> int:
        """Main blocks: depth (tripled for "raw"), less one for each DiT
        block with `use_independent_attn` (the JAX `eff_depth`)."""
        d = self.depth * 3 if self.block_type == "raw" else self.depth
        if self.use_independent_attn and self.use_attn_every_k_layers > 0:
            d = d - d // self.use_attn_every_k_layers
        return d

    @property
    def num_attn_blocks(self) -> int:
        """DiT blocks: one shared, or (depth // k) - 1 independent ones."""
        if self.use_attn_every_k_layers <= 0:
            return 0
        base = self.depth * 3 if self.block_type == "raw" else self.depth
        if self.use_independent_attn:
            return base // self.use_attn_every_k_layers - 1
        return 1


def _gen_paths(cfg: DiMConfig, scan_type: str):
    """The layers' (paths, inverse paths) of a zigzag scan type (the JAX
    `_gen_paths`, dim.py:172-180)."""
    return build_layer_paths(cfg.grid_size, scan_type, cfg.eff_depth)


def _mixer_kwargs_for(i: int, cfg: DiMConfig, paths, paths2):
    """Block i's mixer arguments, and those of the combined_fourier DCT
    half's mixer (jpeg_2, always conditioned), the JAX `_mixer_kwargs_for`
    (dim.py:183-205)."""
    mk = dict(layer_idx=i, scan_type=cfg.scan_type, conv_xproj=cfg.conv_xproj,
              seq_group=cfg.seq_group, seq_island=cfg.seq_group is not None,
              tp_group=cfg.tp_group,
              d_cond=cfg.hidden_size if cfg.cond_mamba else None,
              use_cond_init=cfg.cond_mamba and cfg.use_cond_init)
    if is_zigzag(cfg.scan_type):
        mk.update(zigzag_paths=paths[0], zigzag_paths_reverse=paths[1])
    mk2 = None
    if cfg.block_type == "combined_fourier":
        mk2 = dict(layer_idx=i, scan_type="jpeg_2", conv_xproj=cfg.conv_xproj,
                   tp_group=cfg.tp_group,
                   d_cond=cfg.hidden_size, zigzag_paths=paths2[0],
                   zigzag_paths_reverse=paths2[1])
    return mk, mk2


def make_dim_block(i: int, cfg: DiMConfig, paths=None, paths2=None,
                   drop_path_rate: float = 0.0, pending_tail: int = 0):
    """Block i of `cfg`, the JAX `make_dim_block` (dim.py:208-263)."""
    if cfg.is_moe and i % 2 != 0:  # no stochastic depth (dim.py:212)
        return MoEBlock(cfg.hidden_size, rms_norm=cfg.rms_norm,
                        num_moe_experts=cfg.num_moe_experts,
                        add_bias_linear=cfg.add_bias_linear,
                        gated_linear_unit=cfg.gated_linear_unit,
                        routing_mode=cfg.routing_mode,
                        pallas_norm=cfg.pallas_norm,
                        fused_norm=cfg.fused_norm, dtype=cfg.dtype,
                        residual_in_fp32=cfg.residual_in_fp32,
                        capacity_factor=cfg.moe_capacity_factor,
                        tp_group=cfg.tp_group)
    mk, mk2 = _mixer_kwargs_for(i, cfg, paths, paths2)
    alternate = cfg.scan_type == "none"
    reverse = alternate and i % 2 > 0
    transpose = alternate and i % 4 >= 2
    D = cfg.hidden_size
    common = dict(rms_norm=cfg.rms_norm, pallas_norm=cfg.pallas_norm,
                  fused_norm=cfg.fused_norm, dtype=cfg.dtype,
                  drop_path_rate=drop_path_rate,
                  residual_in_fp32=cfg.residual_in_fp32)
    bt = cfg.block_type
    if bt in ("raw", "linear"):
        return MixerBlockCore(
            D, D, mk, reverse=reverse, transpose=transpose,
            identity_norm=False, no_ffn=bt == "raw",
            scanning_continuity=cfg.scanning_continuity,
            use_gated_mlp=cfg.use_gated_mlp, **common)
    if bt == "wave":  # JAX gives it the gated MLP whatever the flag says
        return WaveDiMBlock(
            D, D, mk, reverse=reverse, transpose=transpose, window_scan=False,
            identity_norm=False, no_ffn=False,
            scanning_continuity=cfg.scanning_continuity, **common)
    if bt == "window":
        return DiMBlockWindow(D, D, mk, transpose=reverse,
                              use_gated_mlp=cfg.use_gated_mlp, **common)
    if bt in ("combined", "combined_fourier", "combined_einfft"):
        variant = {"combined": "wave", "combined_fourier": "dct",
                   "combined_einfft": "einfft"}[bt]
        return DiMBlockCombined(
            D, reverse=reverse, transpose=transpose,
            scanning_continuity=cfg.scanning_continuity,
            use_gated_mlp=cfg.use_gated_mlp, freq_variant=variant,
            mixer_kwargs=mk, mixer_kwargs_2=mk2, pending_tail=pending_tail,
            tp_group=cfg.tp_group, **common)
    raise ValueError(f"unknown block_type {bt!r}: one of {BLOCK_TYPES}")


class DiM(nn.Module):
    def __init__(self, cfg: DiMConfig):
        super().__init__()
        self.cfg = cfg
        D, dt = cfg.hidden_size, cfg.dtype
        if cfg.block_type not in BLOCK_TYPES:
            raise ValueError(f"unknown block_type {cfg.block_type!r}: one "
                             f"of {BLOCK_TYPES}")
        if cfg.pe_type not in PE_TYPES:
            raise ValueError(f"unsupported pe_type {cfg.pe_type!r}: one of "
                             f"{PE_TYPES}")
        self.x_embedder = PatchEmbed(cfg.patch_size, cfg.in_channels, D, dt)
        self.t_embedder = TimestepEmbedder(D, dtype=dt)
        self.y_embedder = LabelEmbedder(cfg.num_classes, D, cfg.label_dropout)
        if cfg.pe_type == "ape":
            self.pos_embed = nn.Parameter(
                torch.tensor(get_2d_sincos_pos_embed(D, cfg.grid_size))[None])
        elif cfg.pe_type == "rope":
            # fp32 tables, not in the state dict (the reference's frozen
            # emb_sin / emb_cos buffers are skipped on load)
            for name, table in zip(("emb_sin", "emb_cos"),
                                   get_2d_sincos_rotary_embed(
                                       D, cfg.grid_size)):
                self.register_buffer(name, torch.tensor(table),
                                     persistent=False)
        else:
            self.pos_cnn = AdaInPosCNN(D, dt)
        n = cfg.eff_depth
        dpr = np.linspace(0.0, cfg.drop_path, n).tolist()
        inter_dpr = [0.0] + dpr
        if cfg.pending_tail not in (0, 1, 2):
            raise ValueError(f"pending_tail must be 0, 1 or 2, got "
                             f"{cfg.pending_tail}")
        self.remat_keep = (remat.parse_policy(cfg.remat_policy)
                           if cfg.grad_checkpoint else None)
        # the pending tuple would cross the checkpoint boundary; only the
        # combined blocks defer their tail
        self.pending_tail = (cfg.pending_tail if not cfg.grad_checkpoint
                             and cfg.block_type.startswith("combined")
                             else 0)
        paths = (_gen_paths(cfg, cfg.scan_type)
                 if is_zigzag(cfg.scan_type) else None)
        paths2 = (_gen_paths(cfg, "jpeg_2")
                  if cfg.block_type == "combined_fourier" else None)
        self.blocks = nn.ModuleList([
            make_dim_block(i, cfg, paths, paths2, inter_dpr[i],
                           self.pending_tail) for i in range(n)])
        if cfg.enable_fourier_layers:
            # auxiliary wavelet blocks after each main block (the JAX
            # working realization of the reference's intent, dim.py:364-383)
            self.fourier_blocks = nn.ModuleList([
                WaveDiMBlock(
                    D, D, dict(layer_idx=i, d_cond=D,
                               conv_xproj=cfg.conv_xproj,
                               tp_group=cfg.tp_group),
                    reverse=i % 2 > 0, window_scan=False,
                    identity_norm=False, no_ffn=False,
                    rms_norm=cfg.rms_norm, pallas_norm=cfg.pallas_norm,
                    fused_norm=cfg.fused_norm,
                    scanning_continuity=cfg.scanning_continuity,
                    drop_path_rate=dpr[i], dtype=dt,
                    residual_in_fp32=cfg.residual_in_fp32)
                for i in range(n)])
        attn = dict(dtype=dt, fused_norm=cfg.fused_norm,
                    use_gated_mlp=cfg.use_gated_mlp, tp_group=cfg.tp_group)
        if cfg.use_attn_every_k_layers > 0:
            if cfg.use_independent_attn:
                self.attn_block = nn.ModuleList([
                    DiTBlock(D, 16, **attn)
                    for _ in range(cfg.num_attn_blocks)])
            else:
                self.attn_block = DiTBlock(D, 16, **attn)
        if cfg.use_final_norm:
            self.norm_f = Norm(D, pallas_norm=cfg.pallas_norm,
                               fused_norm=cfg.fused_norm, rms=cfg.rms_norm)
        self.final_layer = FinalLayer(D, cfg.patch_size, cfg.out_channels,
                                      dt, fused_norm=cfg.fused_norm)
        apply_switches(self, cfg.norm_mxu, cfg.flash_attn, cfg.full_attn,
                       cfg.dwt_cl, cfg.fused_wavelet,
                       cfg.wavelet_one_rearrange)

    def forward(self, x, t, y=None, train: bool = False,
                generator: torch.Generator | None = None,
                force_drop_ids=None):
        """x: (N, C, H, W) latents; t: (N,) times in [0, 1]; y: (N,) labels
        (None: the null class).  `train` turns on label dropout and
        stochastic depth, drawn from `generator` (on x's device);
        `force_drop_ids` (N,), 1 = drop, replaces the label draw.  Returns
        (N, out_channels, H, W)."""
        cfg = self.cfg
        x, c = self.embed(x, t, y, train, generator, force_drop_ids)
        residual = pending = freq_residual = None
        k = cfg.use_attn_every_k_layers
        checkpointed = (self.remat_keep is not None
                        and torch.is_grad_enabled())
        attn_idx = 0
        for i, block in enumerate(self.blocks):
            if checkpointed:
                x, residual = remat.checkpoint(
                    block, self.remat_keep, x, residual, c, train=train,
                    generator=generator)
            elif self.pending_tail > 0 and isinstance(block,
                                                      DiMBlockCombined):
                x, residual, pending = block(x, residual, c, train=train,
                                             generator=generator,
                                             pending=pending)
            else:
                x = materialize_pending(x, pending)
                pending = None
                x, residual = block(x, residual, c, train=train,
                                    generator=generator)
            if cfg.enable_fourier_layers:
                x = materialize_pending(x, pending)
                pending = None
                x, freq_residual = self.fourier_blocks[i](
                    x, freq_residual, c, train=train, generator=generator)
            if k > 0 and (i + 1) % k == 0:
                x = materialize_pending(x, pending)
                pending = None
                if not cfg.use_independent_attn:
                    x = self.attn_block(x, c)
                elif attn_idx < cfg.num_attn_blocks:
                    x = self.attn_block[attn_idx](x, c)
                    attn_idx += 1
        x = materialize_pending(x, pending)
        if cfg.use_final_norm:
            # model-level stochastic depth at the final merge, full rate
            if train and cfg.drop_path > 0.0 and residual is not None:
                x = drop_path_fn(x, cfg.drop_path, generator)
            x = self.norm_f(x, residual, prenorm=False)
        return self.final(x, c)

    def embed(self, x, t, y=None, train: bool = False,
              generator: torch.Generator | None = None,
              force_drop_ids=None):
        """The tokens and the condition before the blocks: (x (N, L, D), c
        (N, D)), both in the compute dtype."""
        cfg = self.cfg
        if y is None:
            y = torch.full((x.shape[0],),
                           self.y_embedder.embedding_table.num_embeddings - 1,
                           dtype=torch.long, device=x.device)
        y_emb = self.y_embedder(y, train=train, force_drop_ids=force_drop_ids,
                                generator=generator)
        c = (self.t_embedder(t) + y_emb).to(cfg.dtype)
        x = self.x_embedder(x.to(cfg.dtype))
        if cfg.pe_type == "ape":
            pos_embed = self.pos_embed if cfg.learnable_pe else \
                self.pos_embed.detach()
            x = x + pos_embed.to(cfg.dtype)
        elif cfg.pe_type == "rope":
            x = apply_rotary(x, self.emb_sin.to(cfg.dtype),
                             self.emb_cos.to(cfg.dtype))
        else:
            x = self.pos_cnn(x, c, cfg.grid_size, cfg.grid_size)
        return x, c

    def final(self, x, c):
        """The FinalLayer and unpatchify: (N, out_channels, H, W) fp32."""
        x = self.final_layer(x, c)
        return unpatchify(x.float(), self.cfg.patch_size,
                          self.cfg.out_channels)


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
def random_init_(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights for runs without a checkpoint.  Every Linear
    and conv draws U(+-1/sqrt(fan_in)) (including the adaLN and final
    layers the JAX init zeroes, so every branch contributes), biases 0,
    the label table N(0, 0.02), EinFFT's complex weights and biases
    N(0, 0.02) (their JAX init); the Mamba A_log, D and dt_proj.bias (and
    v2's A_b_log, D_b, dt_proj_b.bias) keep the Mamba init (dt log-uniform
    in [1e-3, 0.1] through the inverse softplus); norm weights 1, norm
    biases 0; pos_embed, where the model has one, the sin-cos table.  A
    DiT's weights follow the same rules."""
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    keep = {id(p) for m in model.modules()
            if isinstance(m, (Norm, nn.LayerNorm)) for p in m.parameters()}
    if hasattr(model, "pos_embed"):
        keep.add(id(model.pos_embed))
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if id(p) in keep:
            continue  # the constructor's ones / zeros / sin-cos table
        if leaf in ("A_log", "A_b_log"):
            n = p.shape[1]
            p.copy_(torch.log(torch.arange(1, n + 1, device=dev,
                                           dtype=p.dtype)).expand_as(p))
        elif leaf in ("D", "D_b"):
            p.fill_(1.0)
        elif leaf.startswith("complex_"):  # EinFFT: the JAX N(0, 0.02^2)
            p.normal_(0.0, 0.02, generator=g)
        elif name.endswith(("dt_proj.bias", "dt_proj_b.bias")):
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


def init_sharded_(model: nn.Module, full: nn.Module, seed: int) -> nn.Module:
    """Give a tensor-parallel `model` its rank's shards of the seeded
    `random_init_` weights of `full`, the same model without a group (the
    full model's draws, so every --tp builds the same weights)."""
    from dimsum_torch.parallel.mesh import shard_state_dict, tp_rank, tp_size

    group = model.cfg.tp_group
    random_init_(full, seed)
    sd = shard_state_dict(full.state_dict(), tp_rank(group), tp_size(group))
    model.load_state_dict(sd, strict=True)
    return model


def build_dim(cfg: DiMConfig, device="cuda", seed: int = 0,
              train: bool = False) -> DiM:
    """A DiM on `device` (CUDA unless the caller asks for the CPU) with the
    seeded `random_init_` weights (with `cfg.tp_group`, the rank's shards
    of the full model's).  For inference (the default) the Linear
    weights are stored in cfg.dtype and the model is in eval mode; with
    `train=True` every parameter stays fp32 (the master weights the
    optimizer updates; `Linear` casts to cfg.dtype at each call, as the JAX
    package does) and the model is in train mode."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = DiM(cfg)
        if cfg.tp_group is None:
            random_init_(model, seed)
        else:
            init_sharded_(model, DiM(dataclasses.replace(cfg, tp_group=None)),
                          seed)
    if train:
        return model.train()
    return cast_weights_(model).eval()
