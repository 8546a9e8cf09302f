"""DiM blocks, port of `dimsum_tpu/models/blocks.py`: Norm, AdaLN, the
mixer blocks (MixerBlockCore for "linear" and "raw", DiMBlockWindow,
WaveDiMBlock, DCTBlock), EinFFT, the MoE blocks (SwitchMLP, MoEBlock),
DiTBlock and DiMBlockCombined.

Every block follows the reference's prenorm structure: the residual add
comes first (fused add + norm), the summed residual is threaded beside the
hidden states, and the condition enters through adaLN shift/scale/gate.
Token reorderings (transpose, serpentine continuity, windows, wavelet and
DCT packs, reverse) are explicit rearranges, gathers and flips.

The mixer blocks share one body, `_InnerMixerBlock`: add + norm (none in
the combined block's halves, whose identity "norm" `_add_identity_norm`
is left out: no residual enters them there and the one it would return is
discarded), the block's token order, serpentine continuity, the flip of a
reversed block, the mixer under a 3-way adaLN, and with an FFN a fused
gate-add + norm + modulate (`norm_2`) and the MLP under a 6-way adaLN;
then the order undone.  A reversed block runs the reverse inside the
mixer (`reverse_tokens=True`: an anticausal conv and the reverse-time
scan; the JAX `DIMSUM_NATIVE_REVERSE`, blocks.py:155-171) in place of the
two flips whenever nothing needs a gradient: the flip commutes with the
per-batch modulate and gate, so the result is the same, and on the card
it is the scan kernel's reverse entry, as fast as the forward one, with
two launches fewer (PERF.md).  Under a gradient the block keeps the
flips: the scan's backward has no reverse entry, and the flips inside the
mixer would move its 2x wider tensors.  Zigzag mixers gather by a
permutation that does not commute with the reverse, and sequence-parallel
mixers reverse by flips of their own; both keep the block's flips.

The JAX package's fused-kernel switches are constructor arguments here (the
model's `DiMConfig` fields): `pallas_norm` (`DIMSUM_PALLAS_NORM`, the add +
norm kernel at the blocks' top norm), `fused_norm` (`DIMSUM_FUSED_NORM`, the
norm + modulate kernel at norm_2, the DiT block's two norms and the
FinalLayer's), `conv_xproj` (`DIMSUM_CONV_XPROJ`, in every mixer) and
`pending_tail` (`DIMSUM_PENDING_TAIL`: 1 defers each combined block's tail
FFN add into the next block's top norm, 2 also takes the norm + modulate
kernel there).  A `norm_impl` attribute of "ref" on a Norm, DiTBlock or
FinalLayer selects the kernels' plain versions on any device.
`seq_group` (the model's `DiMConfig.seq_group`) runs every mixer's conv and
scan sequence-parallel in island mode (`models/mamba.py`); the blocks'
token reorderings and flips stay outside the islands.  `tp_group` (the
model's `DiMConfig.tp_group`) shards the mixers, the gated MLPs and the
attentions' heads over a model group and splits a MoE block's experts
over it (`parallel/mesh.py`, `parallel/moe_ep.py`); the norms, adaLN and
the token orders run whole on every rank.  `residual_in_fp32` (the JAX
field) reaches each block's top norm, the one that makes the residual;
the JAX switches that act inside blocks are set by `apply_switches`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from einops import rearrange

from dimsum_torch.models.attention import Attention, CrossAttentionFusion
from dimsum_torch.models.linear import Linear
from dimsum_torch.models.mamba import Mamba, is_zigzag
from dimsum_torch.models.mlp import ExpertMLP, GatedMLP, Mlp
from dimsum_torch.ops.cuda_build import needs_grad
from dimsum_torch.ops.dct import dct_patch, idct_patch
from dimsum_torch.ops.norms import fused_add_norm, modulate, norm_modulate
from dimsum_torch.ops.scan_orders import local_reverse, local_scan
from dimsum_torch.ops.wavelet import (dwt_tokens, dwt_tokens_cl,
                                      dwt_tokens_windowed, idwt_tokens,
                                      idwt_tokens_cl, idwt_tokens_windowed,
                                      wavelet_pack_windowed,
                                      wavelet_unpack_windowed,
                                      windows_are_blocks, windows_compose)
from dimsum_torch.parallel.mesh import tp_rank, tp_size
from dimsum_torch.parallel.moe_ep import switch_ep


def drop_path_fn(x, rate: float, generator: torch.Generator | None = None):
    """Per-sample stochastic depth (timm semantics, the JAX `drop_path_fn`,
    blocks.py:77-85): keep each sample with probability 1 - rate and scale
    the kept ones by 1 / (1 - rate).  Callers apply it only in training."""
    keep = 1.0 - rate
    mask = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1),
                      generator=generator, device=x.device) < keep
    return x * (mask.to(x.dtype) / keep)


def materialize_pending(x, pending):
    """Fold a deferred block tail: x + gate * branch (x itself when nothing
    is pending), the JAX `materialize_pending` (blocks.py:116-122)."""
    if pending is None:
        return x
    branch, gate = pending
    return x + gate[:, None, :] * branch


class Norm(nn.Module):
    """RMSNorm (weight only, `rms=True`) or LayerNorm (weight and bias)
    with fp32 math.  With `branch` or `shift` it is the fused (gate-add +)
    add + norm + modulate and returns (modulated, total), through the
    norm + modulate kernel when `fuse` (default: the `fused_norm` switch)
    says so; otherwise fused add + norm, through the add + norm kernel
    with the `pallas_norm` switch (the JAX `Norm.__call__`, blocks.py:55-74).
    The kernels take both norms.  `residual_in_fp32` (the JAX field) keeps
    the new residual in fp32; off, it is carried in x's dtype (the bf16
    residual stream), rounded once where it is made.  The attribute
    `norm_mxu` (the JAX `DIMSUM_NORM_MXU`) takes the composition's
    reductions as ones-column products."""

    def __init__(self, dim: int, eps: float = 1e-5, pallas_norm: bool = False,
                 fused_norm: bool = False, rms: bool = True,
                 residual_in_fp32: bool = True):
        super().__init__()
        self.eps = eps
        self.rms = rms
        self.pallas_norm, self.fused_norm = pallas_norm, fused_norm
        self.residual_in_fp32 = residual_in_fp32
        self.norm_impl: str | None = None
        self.norm_mxu = False
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = None if rms else nn.Parameter(torch.zeros(dim))

    def forward(self, x, residual=None, prenorm=True, branch=None, gate=None,
                shift=None, scale=None, fuse: bool | None = None):
        if branch is not None or shift is not None:
            total_dtype = (torch.float32 if residual is not None
                           and self.residual_in_fp32 else x.dtype)
            return norm_modulate(
                x, self.weight, self.bias, branch=branch, gate=gate,
                residual=residual, shift=shift, scale=scale, eps=self.eps,
                is_rms=self.rms, total_dtype=total_dtype,
                fuse=self.fused_norm if fuse is None else fuse,
                impl=self.norm_impl, mxu=self.norm_mxu)
        return fused_add_norm(x, self.weight, self.bias, residual=residual,
                              eps=self.eps, prenorm=prenorm,
                              residual_in_fp32=self.residual_in_fp32,
                              is_rms=self.rms, kernel=self.pallas_norm,
                              impl=self.norm_impl, mxu=self.norm_mxu)


def AdaLN(c_dim: int, dim: int, n_chunks: int,
          dtype: torch.dtype = torch.float32) -> nn.Sequential:
    """SiLU -> Linear(n_chunks * dim); the JAX package zero-initializes the
    Linear (adaLN-Zero).  Split the output with `.chunk(n_chunks, -1)`."""
    fc = Linear(c_dim, n_chunks * dim, dtype=dtype)
    nn.init.zeros_(fc.weight)
    nn.init.zeros_(fc.bias)
    return nn.Sequential(nn.SiLU(), fc)


def _transpose_tokens(x, h: int, w: int):
    return rearrange(x, "n (h w) c -> n (w h) c", h=h, w=w)


def _scanning_continuity(x, h: int, w: int):
    """Reverse every odd row of the (w h) grouping (serpentine), the JAX
    `_scanning_continuity` (blocks.py:178-184); its own inverse."""
    xg = rearrange(x, "n (w h) c -> n c w h", h=h, w=w).clone()
    xg[:, :, 1::2] = xg[:, :, 1::2].flip(-1)
    return rearrange(xg, "n c w h -> n (w h) c", h=h, w=w)


class _InnerMixerBlock(nn.Module):
    """The mixer blocks' shared body (see the module docstring); a
    subclass gives the token order (`_order`, `_unorder`).

    `mixer_kwargs` go to `Mamba` (d_cond, dtype, conv_xproj, seq_group,
    scan_type, layer_idx and the zigzag paths).  `identity_norm` leaves
    out the top add + norm (the combined block's halves, which take no
    residual and return None for one); otherwise the block takes and
    returns the residual, dropping the incoming hidden states per sample
    at `drop_path_rate` in training where a residual exists (the JAX
    `_maybe_drop_path`).  `no_ffn` keeps the 3-way adaLN without norm_2
    and the MLP."""

    def __init__(self, dim: int, c_dim: int, mixer_kwargs: Dict[str, Any],
                 reverse: bool = False, identity_norm: bool = True,
                 no_ffn: bool = True,
                 rms_norm: bool = True, pallas_norm: bool = False,
                 fused_norm: bool = False, scanning_continuity: bool = False,
                 use_gated_mlp: bool = True, drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 residual_in_fp32: bool = True):
        super().__init__()
        self.reverse = reverse
        self.native = (reverse and mixer_kwargs.get("seq_group") is None
                       and not is_zigzag(mixer_kwargs.get("scan_type",
                                                          "none")))
        self.identity_norm, self.no_ffn = identity_norm, no_ffn
        self.scanning_continuity = scanning_continuity
        self.drop_path_rate = drop_path_rate
        norm_kw = dict(pallas_norm=pallas_norm, fused_norm=fused_norm,
                       rms=rms_norm)
        if not identity_norm:
            self.norm = Norm(dim, residual_in_fp32=residual_in_fp32,
                             **norm_kw)
        self.mixer = Mamba(dim, dtype=dtype, **mixer_kwargs)
        self.adaLN_modulation = AdaLN(c_dim, dim, 3 if no_ffn else 6, dtype)
        if not no_ffn:
            self.norm_2 = Norm(dim, **norm_kw)
            tp = mixer_kwargs.get("tp_group")
            self.mlp = (GatedMLP(dim, 4 * dim, dtype=dtype, tp_group=tp)
                        if use_gated_mlp else Mlp(dim, 4 * dim, dtype=dtype))

    def forward(self, hidden_states, residual=None, c=None,
                train: bool = False,
                generator: torch.Generator | None = None):
        if not self.identity_norm:
            if train and self.drop_path_rate > 0.0 and residual is not None:
                hidden_states = drop_path_fn(
                    hidden_states, self.drop_path_rate, generator)
            hidden_states, residual = self.norm(hidden_states, residual)
        side = int(round(hidden_states.shape[1] ** 0.5))
        hidden_states = self._order(hidden_states, side)
        if self.scanning_continuity:
            hidden_states = _scanning_continuity(hidden_states, side, side)
        native = self.native and not needs_grad(hidden_states)
        flip = self.reverse and not native
        if flip:
            hidden_states = hidden_states.flip(1)
        mods = self.adaLN_modulation(c).chunk(3 if self.no_ffn else 6, -1)
        shift, scale, gate = mods[:3]
        mixer_out = self.mixer(modulate(hidden_states, shift, scale), c,
                               reverse_tokens=native)
        if self.no_ffn:
            hidden_states = hidden_states + gate[:, None, :] * mixer_out
        else:
            shift_mlp, scale_mlp, gate_mlp = mods[3:]
            moded, hidden_states = self.norm_2(
                hidden_states, prenorm=False, branch=mixer_out, gate=gate,
                shift=shift_mlp, scale=scale_mlp)
            hidden_states = hidden_states + gate_mlp[:, None, :] * self.mlp(
                moded)
        if flip:
            hidden_states = hidden_states.flip(1)
        if self.scanning_continuity:
            hidden_states = _scanning_continuity(hidden_states, side, side)
        return self._unorder(hidden_states, side), residual


class MixerBlockCore(_InnerMixerBlock):
    """Tokens in raster order, transposed to column order when
    `transpose` (the JAX `MixerBlockCore`, blocks.py:187-264): the
    "linear" block with `no_ffn=False`, the "raw" block (DiMBlockRaw) with
    its own norm and no FFN, and the combined block's spatial half with
    neither."""

    def __init__(self, dim: int, c_dim: int, mixer_kwargs: Dict[str, Any],
                 transpose: bool = False, **kw):
        super().__init__(dim, c_dim, mixer_kwargs, **kw)
        self.transpose = transpose

    def _order(self, x, side):
        return _transpose_tokens(x, side, side) if self.transpose else x

    _unorder = _order


class DiMBlockWindow(_InnerMixerBlock):
    """Windowed scan (the JAX `DiMBlockWindow`, blocks.py:277-337):
    `local_scan` in 4 x 4 windows (column first with `transpose`), rolled
    by one token on both axes with `shift_window`; its own norm and FFN."""

    window = 4

    def __init__(self, dim: int, c_dim: int, mixer_kwargs: Dict[str, Any],
                 transpose: bool = False, shift_window: bool = False, **kw):
        super().__init__(dim, c_dim, mixer_kwargs, identity_norm=False,
                         no_ffn=False, **kw)
        self.column_first = bool(transpose)
        self.shift_window = shift_window

    def _roll(self, x, side, shift):
        xg = x.reshape(-1, side, side, x.shape[-1])
        return torch.roll(xg, (shift, shift), (1, 2)).reshape(x.shape)

    def _order(self, x, side):
        x = local_scan(x, w=self.window, H=side, W=side,
                       column_first=self.column_first)
        return self._roll(x, side, -1) if self.shift_window else x

    def _unorder(self, x, side):
        if self.shift_window:
            x = self._roll(x, side, 1)
        return local_reverse(x, w=self.window, H=side, W=side,
                             column_first=self.column_first)


class WaveDiMBlock(_InnerMixerBlock):
    """The frequency branch (the JAX `WaveDiMBlock`, blocks.py:340-493): a
    `num_lv`-level Haar pack, then with `window_scan` a windowed scan order
    (column first when `transpose`), the JAX default routing
    (blocks.py:398-436, :481-492): where the windows are the dwt blocks
    (side == patch**2, 256 px) one rearrange does both; otherwise (512 px:
    side 32, window 8) `dwt_tokens`, then `local_scan` over side // patch
    windows.  Without `window_scan` (the standalone "wave" block and the
    auxiliary fourier blocks) the packed tokens are transposed when
    `transpose`.  The combined block's frequency half has no norm and no
    FFN; the other uses have both.

    The JAX opt-in packs are attributes (the model's `DiMConfig` fields
    `dwt_cl`, `fused_wavelet`, `wavelet_one_rearrange`), taken under the
    JAX gates in the JAX order (blocks.py:385-436): the channel-last pack
    (`ops/wavelet.py::dwt_tokens_cl`), the basis pack
    (`wavelet_pack_windowed`), the one-rearrange pack also where the
    window is a multiple of the block (512 px), else the routes above."""

    def __init__(self, dim: int, c_dim: int, mixer_kwargs: Dict[str, Any],
                 transpose: bool = False, window_scan: bool = True,
                 num_lv: int = 2, **kw):
        super().__init__(dim, c_dim, mixer_kwargs, **kw)
        self.transpose = bool(transpose)
        self.window_scan = window_scan
        self.num_lv = num_lv
        self.dwt_cl = self.fused_wavelet = False
        self.wavelet_one_rearrange = False

    def _window(self, side):
        return dict(w=side // 2 ** self.num_lv, H=side, W=side,
                    column_first=self.transpose)

    def _route(self, L, C):
        """"cl", "fused", "one" or "default", by the JAX gates."""
        side = int(round(L ** 0.5))
        patch = 2 ** self.num_lv
        packs = C % patch ** 2 == 0 and side % patch == 0
        fused = self.window_scan and packs and self.fused_wavelet
        if (self.dwt_cl and not fused and self.num_lv in (1, 2) and packs
                and (not self.window_scan or (side // patch) % patch == 0
                     or side // patch == patch)):
            return "cl"
        if fused:
            return "fused"
        if self.window_scan and (
                windows_are_blocks(L, self.num_lv)
                or (self.wavelet_one_rearrange
                    and windows_compose(L, self.num_lv))):
            return "one"
        return "default"

    def _cl_kw(self):
        return dict(window_scan=self.window_scan,
                    grid_transpose=self.transpose and not self.window_scan,
                    column_first=self.transpose)

    def _order(self, x, side):
        route = self._route(x.shape[1], x.shape[2])
        if route == "cl":
            return dwt_tokens_cl(x, self.num_lv, **self._cl_kw())
        if route == "fused":
            return wavelet_pack_windowed(x, self.num_lv,
                                         column_first=self.transpose)
        if route == "one":
            return dwt_tokens_windowed(x, self.num_lv,
                                       column_first=self.transpose)
        x = dwt_tokens(x, self.num_lv)
        if self.window_scan:
            return local_scan(x, **self._window(side))
        return _transpose_tokens(x, side, side) if self.transpose else x

    def _unorder(self, x, side):
        route = self._route(x.shape[1], x.shape[2])
        if route == "cl":
            return idwt_tokens_cl(x, self.num_lv, **self._cl_kw())
        if route == "fused":
            return wavelet_unpack_windowed(x, self.num_lv,
                                           column_first=self.transpose)
        if route == "one":
            return idwt_tokens_windowed(x, self.num_lv,
                                        column_first=self.transpose)
        if self.window_scan:
            x = local_reverse(x, **self._window(side))
        elif self.transpose:
            x = _transpose_tokens(x, side, side)
        return idwt_tokens(x, self.num_lv)


class DCTBlock(_InnerMixerBlock):
    """The DCT frequency branch (the JAX `DCTBlock`, blocks.py:496-578):
    the patchwise frozen-basis DCT in dct_size x dct_size patches, the
    coefficients regrouped `(c p1 p2) -> (h p1 w p2)` into tokens (then
    transposed when `transpose`), and back through the inverse DCT.  The
    packs compute in fp32, so a bf16 model's DCT branch carries fp32
    hidden states, as JAX promotes them."""

    def __init__(self, dim: int, c_dim: int, mixer_kwargs: Dict[str, Any],
                 transpose: bool = False, dct_size: int = 2, **kw):
        super().__init__(dim, c_dim, mixer_kwargs, **kw)
        self.transpose = transpose
        self.dct_size = dct_size

    def _order(self, x, side):
        k = self.dct_size
        xg = rearrange(x, "b (h w) d -> b d h w", h=side)
        xg = dct_patch(xg, k, k)
        x = rearrange(xg, "b (c p1 p2) h w -> b (h p1 w p2) c",
                      c=x.shape[-1], p1=k)
        return _transpose_tokens(x, side, side) if self.transpose else x

    def _unorder(self, x, side):
        k = self.dct_size
        if self.transpose:
            x = _transpose_tokens(x, side, side)
        xg = rearrange(x, "b (h p1 w p2) c -> b (c p1 p2) h w",
                       c=x.shape[-1], p1=k, p2=k, h=side // k)
        return rearrange(idct_patch(xg, k, k), "b c h w -> b (h w) c")


class EinFFT(nn.Module):
    """SiMBA's spectral channel MLP (the JAX `EinFFT`, blocks.py:581-621):
    a 2-D FFT over (tokens, channel blocks) in complex64 with "ortho"
    norm, two block-diagonal complex layers (ReLU between), softshrink,
    the inverse FFT, and the real part in the input's dtype.  JAX computes
    it with `jnp.fft` outside any kernel; here `torch.fft`.  Called as the
    combined block's other frequency halves are, (x, residual, c) ->
    (x, residual): it takes no condition and passes the residual on."""

    def __init__(self, dim: int, num_blocks: int = 4,
                 sparsity_threshold: float = 0.01, scale: float = 0.02):
        super().__init__()
        self.num_blocks = num_blocks
        self.sparsity_threshold = sparsity_threshold
        bs = dim // num_blocks
        for i in (1, 2):
            setattr(self, f"complex_weight_{i}", nn.Parameter(
                scale * torch.randn(2, num_blocks, bs, bs)))
            setattr(self, f"complex_bias_{i}", nn.Parameter(
                scale * torch.randn(2, num_blocks, bs)))

    def forward(self, x, residual=None, c=None):
        B, N, C = x.shape
        w1, w2 = self.complex_weight_1, self.complex_weight_2
        b1, b2 = self.complex_bias_1, self.complex_bias_2
        xb = x.reshape(B, N, self.num_blocks, C // self.num_blocks)
        xf = torch.fft.fft2(xb.to(torch.complex64), dim=(1, 2),
                            norm="ortho")

        def mul(v, w):
            return torch.einsum("...bd,bdk->...bk", v, w)

        r1 = F.relu(mul(xf.real, w1[0]) - mul(xf.imag, w1[1]) + b1[0])
        i1 = F.relu(mul(xf.real, w1[1]) + mul(xf.imag, w1[0]) + b1[1])
        r2 = mul(r1, w2[0]) - mul(i1, w2[1]) + b2[0]
        i2 = mul(r1, w2[1]) + mul(i1, w2[0]) + b2[1]

        lam = self.sparsity_threshold

        def softshrink(v):
            return torch.sign(v) * torch.clamp(v.abs() - lam, min=0.0)

        out = torch.fft.ifft2(torch.complex(softshrink(r2), softshrink(i2)),
                              dim=(1, 2), norm="ortho")
        return out.real.to(x.dtype).reshape(B, N, C), residual


class SwitchMLP(nn.Module):
    """Top-1 routed MoE FFN on one device, the JAX `SwitchMLP`'s dense
    dispatch (blocks.py:624-690): an fp32 router `Dense(E)` (flax promotes
    the input to its fp32 weights), routing probabilities by softmax
    ("top1") or, for "sinkhorn", a sigmoid with no Sinkhorn iterations (what
    JAX computes, whatever the name says); every expert runs on every token
    and the argmax expert's output, picked by a one-hot in x's dtype, is
    scaled by its probability.  The output is fp32, as JAX promotes it.
    The other modes of the CLI ("top2", "sinkhorn_top2") take the top1
    path, as in JAX.

    With `tp_group` it is the JAX expert-parallel route (`ep_axis`, which
    JAX takes whenever --tp > 1 with --is-moe): this rank holds experts
    [m E / k, (m + 1) E / k) of the group's k ranks (`local_experts`, a
    ModuleDict keyed by the global index, so the names stay the
    reference's), and tokens go through capacity dispatch at
    `capacity_factor` (`parallel/moe_ep.py::switch_ep`)."""

    def __init__(self, dim: int, num_moe_experts: int = 8,
                 add_bias_linear: bool = False,
                 gated_linear_unit: bool = True, routing_mode: str = "top1",
                 dtype: torch.dtype = torch.float32,
                 capacity_factor: float = 2.0, tp_group=None):
        super().__init__()
        self.num_moe_experts = num_moe_experts
        self.routing_mode = routing_mode
        self.capacity_factor = capacity_factor
        self.tp_group = tp_group
        self.router = Linear(dim, num_moe_experts, dtype=torch.float32)

        def expert():
            return ExpertMLP(dim, add_bias_linear, gated_linear_unit,
                             dtype=dtype)

        if tp_group is None:
            self.local_experts = nn.ModuleList(
                [expert() for _ in range(num_moe_experts)])
            return
        k, m = tp_size(tp_group), tp_rank(tp_group)
        if num_moe_experts % k:
            raise ValueError(f"{num_moe_experts} experts do not split over "
                             f"{k} ranks")
        per = num_moe_experts // k
        self.local_experts = nn.ModuleDict(
            {str(e): expert() for e in range(m * per, (m + 1) * per)})

    def forward(self, x, c=None):
        logits = self.router(x)
        if self.tp_group is not None:
            return switch_ep(
                x, logits, {int(e): mlp for e, mlp in
                            self.local_experts.items()},
                self.num_moe_experts, self.tp_group, self.capacity_factor,
                self.routing_mode)
        route = (torch.sigmoid(logits) if self.routing_mode == "sinkhorn"
                 else torch.softmax(logits, dim=-1))
        max_prob, max_ind = route.max(dim=-1, keepdim=True)
        onehot = F.one_hot(max_ind[..., 0], self.num_moe_experts).to(x.dtype)
        out = torch.zeros_like(x)
        for e, expert in enumerate(self.local_experts):
            out = out + onehot[..., e:e + 1] * expert(x)
        return out * max_prob


class MoEBlock(nn.Module):
    """Add + norm, then `SwitchMLP` (the JAX `MoEBlock`, blocks.py:693-724);
    it takes no stochastic depth (the reference gives it none), and
    `train` and `generator` are accepted for a uniform call."""

    def __init__(self, dim: int, rms_norm: bool = True,
                 num_moe_experts: int = 8, add_bias_linear: bool = False,
                 gated_linear_unit: bool = True, routing_mode: str = "top1",
                 pallas_norm: bool = False, fused_norm: bool = False,
                 dtype: torch.dtype = torch.float32,
                 residual_in_fp32: bool = True, capacity_factor: float = 2.0,
                 tp_group=None):
        super().__init__()
        self.norm = Norm(dim, pallas_norm=pallas_norm, fused_norm=fused_norm,
                         rms=rms_norm, residual_in_fp32=residual_in_fp32)
        self.mixer = SwitchMLP(dim, num_moe_experts, add_bias_linear,
                               gated_linear_unit, routing_mode, dtype=dtype,
                               capacity_factor=capacity_factor,
                               tp_group=tp_group)

    def forward(self, hidden_states, residual=None, c=None,
                train: bool = False,
                generator: torch.Generator | None = None):
        hidden_states, residual = self.norm(hidden_states, residual)
        return self.mixer(hidden_states), residual


class DiTBlock(nn.Module):
    """adaLN-Zero attention block; its LayerNorms use eps 1e-6, no affine,
    each fused with its modulate (through the kernel with `fused_norm`;
    `norm_mxu` as `Norm`'s).  `tp_group` splits the attention's heads and
    the gated MLP over the group (timm's `Mlp` stays whole, as under the
    JAX rules)."""

    def __init__(self, hidden_size: int, num_heads: int,
                 mlp_ratio: float = 4.0, dtype: torch.dtype = torch.float32,
                 fused_norm: bool = False, use_gated_mlp: bool = True,
                 tp_group=None):
        super().__init__()
        self.fused_norm = fused_norm
        self.norm_impl: str | None = None
        self.norm_mxu = False
        self.attn = Attention(hidden_size, num_heads, qkv_bias=True,
                              dtype=dtype, tp_group=tp_group)
        hidden = int(hidden_size * mlp_ratio)
        self.mlp = (GatedMLP(hidden_size, hidden, dtype=dtype,
                             tp_group=tp_group) if use_gated_mlp
                    else Mlp(hidden_size, hidden, dtype=dtype))
        self.adaLN_modulation = AdaLN(hidden_size, hidden_size, 6, dtype)

    def forward(self, x, c):
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
         gate_mlp) = self.adaLN_modulation(c).chunk(6, -1)
        kw = dict(eps=1e-6, is_rms=False, fuse=self.fused_norm,
                  impl=self.norm_impl, mxu=self.norm_mxu)
        h1, _ = norm_modulate(x, None, shift=shift_msa, scale=scale_msa, **kw)
        h2, x = norm_modulate(x, None, branch=self.attn(h1), gate=gate_msa,
                              shift=shift_mlp, scale=scale_mlp, **kw)
        return x + gate_mlp[:, None, :] * self.mlp(h2)


class DiMBlockCombined(nn.Module):
    """The published DiMSUM block: add + norm -> split channels -> spatial
    half through a mixer block and frequency half through `freq_variant`
    ("wave": a wavelet block, which scans column first in the reversed
    blocks; "dct": a DCT block of dct_size 4 whose mixer takes
    `mixer_kwargs_2`, the jpeg_2 zigzag; "einfft": EinFFT) ->
    CrossAttentionFusion -> residual -> adaLN-gated MLP (the JAX
    `DiMBlockCombined`, blocks.py:758-858).  The halves have no norm and
    no FFN.

    In training, stochastic depth at `drop_path_rate` drops the incoming
    hidden states per sample where they merge into the residual, and only
    when a residual exists (blocks.py:94-98, :784-793).

    With `pending_tail` > 0 the block returns its tail FFN add unmade, as a
    third result (mlp_out, gate_mlp), and takes the previous block's as
    `pending`: its top norm then adds it with the residual in one
    norm + modulate (blocks.py:778-805, :855-858)."""

    def __init__(self, dim: int, reverse: bool = False,
                 transpose: bool = False, d_cond: int | None = None,
                 drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32, pallas_norm: bool = False,
                 fused_norm: bool = False, conv_xproj: bool = False,
                 pending_tail: int = 0, seq_group=None,
                 rms_norm: bool = True, use_gated_mlp: bool = True,
                 scanning_continuity: bool = False,
                 freq_variant: str = "wave",
                 mixer_kwargs: Optional[Dict[str, Any]] = None,
                 mixer_kwargs_2: Optional[Dict[str, Any]] = None,
                 residual_in_fp32: bool = True, tp_group=None):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.pending_tail = pending_tail
        half = dim // 2
        norm_kw = dict(pallas_norm=pallas_norm, fused_norm=fused_norm,
                       rms=rms_norm)
        if mixer_kwargs is None:
            mixer_kwargs = dict(d_cond=d_cond, conv_xproj=conv_xproj,
                                seq_group=seq_group,
                                seq_island=seq_group is not None)
        inner = dict(dtype=dtype, scanning_continuity=scanning_continuity)
        self.norm = Norm(dim, residual_in_fp32=residual_in_fp32, **norm_kw)
        self.spatial_mamba = MixerBlockCore(
            half, dim, mixer_kwargs, reverse=reverse, transpose=transpose,
            **inner)
        if freq_variant == "wave":
            self.freq_mamba = WaveDiMBlock(half, dim, mixer_kwargs,
                                           transpose=reverse, **inner)
        elif freq_variant == "dct":
            self.freq_mamba = DCTBlock(half, dim, mixer_kwargs_2,
                                       dct_size=4, **inner)
        elif freq_variant == "einfft":
            self.freq_mamba = EinFFT(half)
        else:
            raise ValueError(f"unknown freq_variant {freq_variant!r}")
        self.proj = CrossAttentionFusion(dim, num_heads=8, qkv_bias=True,
                                         dtype=dtype, tp_group=tp_group)
        self.adaLN_modulation = AdaLN(dim, dim, 3, dtype)
        self.norm_2 = Norm(dim, **norm_kw)
        self.mlp = (GatedMLP(dim, 4 * dim, dtype=dtype, tp_group=tp_group)
                    if use_gated_mlp else Mlp(dim, 4 * dim, dtype=dtype))

    def forward(self, hidden_states, residual=None, c=None,
                train: bool = False,
                generator: torch.Generator | None = None, pending=None):
        drop = train and self.drop_path_rate > 0.0 and residual is not None
        if pending is not None and drop:
            # stochastic depth drops the whole previous block output
            hidden_states = materialize_pending(hidden_states, pending)
            pending = None
        if pending is None:
            if drop:
                hidden_states = drop_path_fn(
                    hidden_states, self.drop_path_rate, generator)
            hidden_states, residual = self.norm(hidden_states, residual)
        else:
            hidden_states, residual = self.norm(
                hidden_states, residual, branch=pending[0], gate=pending[1],
                fuse=True if self.pending_tail == 2 else None)
        x1, x2 = hidden_states.chunk(2, dim=2)
        x1, _ = self.spatial_mamba(x1, None, c)
        x2, _ = self.freq_mamba(x2, None, c)
        fused = self.proj(x1, x2)
        shift_mlp, scale_mlp, gate_mlp = self.adaLN_modulation(c).chunk(3, -1)
        moded, hidden_states = self.norm_2(
            hidden_states, prenorm=False, branch=fused, shift=shift_mlp,
            scale=scale_mlp)
        mlp_out = self.mlp(moded)
        if self.pending_tail > 0:
            return hidden_states, residual, (mlp_out, gate_mlp)
        hidden_states = hidden_states + gate_mlp[:, None, :] * mlp_out
        return hidden_states, residual


def apply_switches(model: nn.Module, norm_mxu: bool = False,
                   flash_attn: str = "auto", full_attn: str = "auto",
                   dwt_cl: bool = False, fused_wavelet: bool = False,
                   wavelet_one_rearrange: bool = False) -> nn.Module:
    """Set the JAX opt-in switches that act inside modules (the model's
    config fields, from the environment through
    `models/factory.py::env_switches`) on every module they reach:
    `norm_mxu` on the norms (Norm, DiTBlock, FinalLayer), `flash_attn` and
    `full_attn` on the attentions, the wavelet packs on WaveDiMBlock."""
    from dimsum_torch.models.attention import _Routed
    from dimsum_torch.models.embedders import FinalLayer

    for m in model.modules():
        if isinstance(m, (Norm, DiTBlock, FinalLayer)):
            m.norm_mxu = norm_mxu
        if isinstance(m, _Routed):
            m.flash_attn, m.full_attn = flash_attn, full_attn
        if isinstance(m, WaveDiMBlock):
            m.dwt_cl, m.fused_wavelet = dwt_cl, fused_wavelet
            m.wavelet_one_rearrange = wavelet_one_rearrange
    return model
