"""The plain reference of the benchmark's models: DiM-L/2 ("combined"
blocks: a Mamba half in raster order and a Haar-wavelet half in windowed
order, fused by bidirectional cross attention, with a shared DiT block
after every k-th block) and DiT-XL/2 (adaLN-Zero blocks with timm's MLP),
in float32 with plain PyTorch operations.

Frozen from the port's plain routes at commit 47e520a
(`dimsum_torch/models/{dim,dit,blocks,mamba,attention,mlp,embedders}.py`,
`dimsum_torch/ops/{norms,wavelet,scan_orders,causal_conv1d}.py` and
`selective_scan.py::selective_scan_ref`), and imports nothing of the port.
The parameters carry the port's state-dict names, so one state dict loads
into both.  What differs from the port is only how the same mathematics is
computed: every product in float32 with TF32 off (`Precision`), the
reversed blocks by explicit flips, the wavelet pack in two steps
(`dwt_tokens`, then the windowed order), the attention as a softmax of
the full score matrix, and the selective scan as its sequential
recurrence.  `Precision("fp8")` is the control: the same model with
every product of the forward and the backward in float8.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def _round(t, fmt, fmax):
    """t rounded to the float8 format `fmt` after a per-tensor scale that
    maps its largest magnitude to the format's largest, `fmax`."""
    s = fmax / t.abs().amax().clamp_min(1e-30)
    return (t * s).to(fmt).float() / s


E4M3 = (torch.float8_e4m3fn, 448.0)     # values
E5M2 = (torch.float8_e5m2, 57344.0)     # gradients


class _Fp8Product(torch.autograd.Function):
    """a @ b with both operands in e4m3; in the backward the incoming
    gradient in e5m2 times the rounded operands (the usual float8 training
    recipe): every product of the forward and the backward in float8."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _round(a, *E4M3), _round(b, *E4M3)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _round(g, *E5M2)
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        gb = torch.matmul(qa.transpose(-1, -2), qg)
        if gb.dim() > qb.dim():
            gb = gb.reshape(-1, *qb.shape).sum(0)
        return ga, gb


class Precision:
    """The arithmetic of the reference's products (its Linear layers and
    the attention's two products): "fp32" (float32, TF32 off while
    `fp32_matmul` is entered) or "fp8", the control: each product's
    operands in float8 e4m3 and its result rounded to e4m3 (per-tensor
    scales), the backward's products on e5m2 gradients, all taken in
    float32, as a bfloat16 model's products take and give bfloat16."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def _out(self, y):
        """The result rounded to e4m3; its gradient passes unchanged (the
        products' backward rounds it)."""
        return y + (_round(y.detach(), *E4M3) - y.detach())

    def linear(self, x, w, b=None):
        if self.kind == "fp32":
            y = F.linear(x.float(), w.float())
            return y if b is None else y + b.float()
        y = _Fp8Product.apply(x.float(), w.float().t())
        return self._out(y if b is None else y + b.float())

    def matmul(self, a, b):
        if self.kind == "fp32":
            return torch.matmul(a.float(), b.float())
        return self._out(_Fp8Product.apply(a.float(), b.float()))


class fp32_matmul:
    """Context: float32 products without TF32 (cuBLAS and cuDNN)."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
        return False


class Linear(nn.Module):
    def __init__(self, fan_in: int, fan_out: int, prec: Precision,
                 bias: bool = True):
        super().__init__()
        self.prec = prec
        self.weight = nn.Parameter(torch.empty(fan_out, fan_in))
        self.bias = nn.Parameter(torch.empty(fan_out)) if bias else None

    def forward(self, x):
        return self.prec.linear(x, self.weight, self.bias)


class Seq(nn.Module):
    """SiLU -> Linear under the name `<module>.1` (the port's
    nn.Sequential(SiLU, Linear) layout)."""

    def __init__(self, fan_in, fan_out, prec):
        super().__init__()
        self.add_module("1", Linear(fan_in, fan_out, prec))

    def forward(self, c):
        return getattr(self, "1")(F.silu(c))


def rms_norm(x, w, eps=1e-5):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def layer_norm(x, eps=1e-6):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def modulate(x, shift, scale):
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def softplus(x):
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def attention(q, k, v, prec: Precision):
    """q, k, v (B, L, H, Dh) -> (B, L, H, Dh): softmax(q k^T / sqrt(Dh)) v
    over the full score matrix."""
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    s = prec.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return prec.matmul(torch.softmax(s, -1), v).transpose(1, 2)


class _Recurrence(torch.autograd.Function):
    """H_t = a_t H_(t-1) + x_t along dim 1 from H_(-1) = 0, for a, x
    (b, L, d, n), with its backward written out (g_t = dH_t + a_(t+1)
    g_(t+1); dx_t = g_t; da_t = g_t H_(t-1)): autograd through the loop
    would add a full-size gradient for every step's slice."""

    @staticmethod
    def forward(ctx, a, x):
        H = torch.empty_like(x)
        h = torch.zeros_like(x[:, 0])
        for t in range(x.shape[1]):
            h = torch.addcmul(x[:, t], a[:, t], h)
            H[:, t] = h
        ctx.save_for_backward(a, H)
        return H

    @staticmethod
    def backward(ctx, gH):
        a, H = ctx.saved_tensors
        gx = torch.empty_like(gH)
        g = gH[:, -1]
        gx[:, -1] = g
        for t in range(gH.shape[1] - 2, -1, -1):
            g = torch.addcmul(gH[:, t], a[:, t + 1], g)
            gx[:, t] = g
        ga = torch.zeros_like(a)
        ga[:, 1:] = gx[:, 1:] * H[:, :-1]
        return ga, gx


def selective_scan(u, delta, A, B, C, D, z):
    """The S6 recurrence h_t = exp(delta_t A) h_{t-1} + delta_t u_t B_t,
    y_t = C_t . h_t + D u_t, gated by silu(z); u, delta, z (b, L, d);
    B, C (b, L, n); A (d, n)."""
    dA = torch.exp(delta[..., None] * A)
    dBu = (delta * u)[..., None] * B[:, :, None, :]
    H = _Recurrence.apply(dA, dBu)
    y = (H * C[:, :, None, :]).sum(-1) + u * D
    return y * F.silu(z)


def causal_conv1d_silu(x, w, b):
    """Depthwise causal conv over L of x (b, L, d) with w (d, 1, W), then
    SiLU."""
    L = x.shape[1]
    y = F.conv1d(x.transpose(1, 2), w, b, padding=w.shape[-1] - 1,
                 groups=x.shape[-1])[..., :L]
    return F.silu(y.transpose(1, 2))


# ---------------------------------------------------------------------------
# token orders
# ---------------------------------------------------------------------------

def grid(x):
    """(B, L, C) raster tokens -> (B, C, h, w)."""
    B, L, C = x.shape
    s = int(round(L ** 0.5))
    return x.reshape(B, s, s, C).permute(0, 3, 1, 2)


def tokens(g):
    """(B, C, h, w) -> (B, h w, C)."""
    B, C, h, w = g.shape
    return g.permute(0, 2, 3, 1).reshape(B, h * w, C)


def transpose_tokens(x):
    B, L, C = x.shape
    s = int(round(L ** 0.5))
    return x.reshape(B, s, s, C).transpose(1, 2).reshape(B, L, C)


def dwt2d(x):
    B, C, H, W = x.shape
    xb = x.reshape(B, C, H // 2, 2, W // 2, 2)
    a, b = xb[:, :, :, 0, :, 0], xb[:, :, :, 0, :, 1]
    c, d = xb[:, :, :, 1, :, 0], xb[:, :, :, 1, :, 1]
    return torch.cat([0.5 * (a + b + c + d), 0.5 * (a + b - c - d),
                      0.5 * (a - b + c - d), 0.5 * (a - b - c + d)], 1)


def idwt2d(x):
    B, C4, H, W = x.shape
    ll, lh, hl, hh = x.chunk(4, dim=1)
    a = 0.5 * (ll + lh + hl + hh)
    b = 0.5 * (ll + lh - hl - hh)
    c = 0.5 * (ll - lh + hl - hh)
    d = 0.5 * (ll - lh - hl + hh)
    out = torch.stack([torch.stack([a, b], -1), torch.stack([c, d], -1)], -2)
    return out.permute(0, 1, 2, 4, 3, 5).reshape(B, C4 // 4, 2 * H, 2 * W)


_GROUPS = [i % 4 * 4 + i // 4 for i in range(16)]  # the 2-level interleave


def dwt_tokens(x):
    """The 2-level Haar pack of (B, L, C) tokens, subbands interleaved as
    the published model does, to (h p1 w p2) token order, p = 4."""
    g = (dwt2d(dwt2d(grid(x))) / 4.0).chunk(16, 1)
    sub = torch.cat([g[i] for i in _GROUPS], 1)
    B, C16, h, w = sub.shape
    c = C16 // 16
    return (sub.reshape(B, c, 4, 4, h, w).permute(0, 4, 2, 5, 3, 1)
            .reshape(B, h * w * 16, c))


def idwt_tokens(x):
    B, L, c = x.shape
    h = int(round(L ** 0.5)) // 4
    sub = ((x * 4.0).reshape(B, h, 4, h, 4, c).permute(0, 5, 2, 4, 1, 3)
           .reshape(B, 16 * c, h, h))
    g = sub.chunk(16, 1)
    sub = torch.cat([g[i] for i in _GROUPS], 1)
    return tokens(idwt2d(idwt2d(sub)))


def local_scan(x, w, column_first):
    B, L, C = x.shape
    s = int(round(L ** 0.5))
    xg = x.reshape(B, s // w, w, s // w, w, C)
    xg = xg.permute(0, 3, 1, 4, 2, 5) if column_first else \
        xg.permute(0, 1, 3, 2, 4, 5)
    return xg.reshape(B, L, C)


def local_reverse(x, w, column_first):
    B, L, C = x.shape
    s = int(round(L ** 0.5))
    if column_first:
        xg = x.reshape(B, s // w, s // w, w, w, C).permute(0, 2, 4, 1, 3, 5)
    else:
        xg = x.reshape(B, s // w, s // w, w, w, C).permute(0, 1, 3, 2, 4, 5)
    return xg.reshape(B, L, C)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class Mamba(nn.Module):
    """CondMamba as the published model runs it: cond_proj exists and
    stays out of the graph."""

    def __init__(self, d_model, prec, d_state=16, d_conv=4, expand=2,
                 d_cond=None):
        super().__init__()
        d_inner = expand * d_model
        self.r, self.n = math.ceil(d_model / 16), d_state
        self.in_proj = Linear(d_model, 2 * d_inner, prec, bias=False)
        self.conv1d = nn.Module()
        self.conv1d.weight = nn.Parameter(torch.empty(d_inner, 1, d_conv))
        self.conv1d.bias = nn.Parameter(torch.empty(d_inner))
        self.x_proj = Linear(d_inner, self.r + 2 * d_state, prec, bias=False)
        self.dt_proj = nn.Module()
        self.dt_proj.weight = nn.Parameter(torch.empty(d_inner, self.r))
        self.dt_proj.bias = nn.Parameter(torch.empty(d_inner))
        self.A_log = nn.Parameter(torch.empty(d_inner, d_state))
        self.D = nn.Parameter(torch.empty(d_inner))
        self.out_proj = Linear(d_inner, d_model, prec, bias=False)
        if d_cond is not None:
            self.cond_proj = Linear(d_cond, d_inner, prec)

    def forward(self, x):
        x_in, z = self.in_proj(x).chunk(2, -1)
        xc = causal_conv1d_silu(x_in, self.conv1d.weight, self.conv1d.bias)
        dt_low, Bm, Cm = self.x_proj(xc).split([self.r, self.n, self.n], -1)
        delta = softplus(dt_low @ self.dt_proj.weight.t()
                         + self.dt_proj.bias)
        y = selective_scan(xc, delta, -torch.exp(self.A_log), Bm, Cm,
                           self.D, z)
        return self.out_proj(y)


class MixerHalf(nn.Module):
    """A combined block's half: its token order, the reversed blocks'
    flip, the mixer under a 3-way adaLN (shift, scale, gate)."""

    def __init__(self, dim, c_dim, prec, order, reverse, column_first):
        super().__init__()
        self.order, self.reverse = order, reverse
        self.column_first = column_first
        self.mixer = Mamba(dim, prec, d_cond=c_dim)
        self.adaLN_modulation = Seq(c_dim, 3 * dim, prec)

    def _order(self, x):
        if self.order == "wave":
            w = int(round(x.shape[1] ** 0.5)) // 4
            return local_scan(dwt_tokens(x), w, self.column_first)
        return transpose_tokens(x) if self.column_first else x

    def _unorder(self, x):
        if self.order == "wave":
            w = int(round(x.shape[1] ** 0.5)) // 4
            return idwt_tokens(local_reverse(x, w, self.column_first))
        return transpose_tokens(x) if self.column_first else x

    def forward(self, x, c):
        h = self._order(x)
        if self.reverse:
            h = h.flip(1)
        shift, scale, gate = self.adaLN_modulation(c).chunk(3, -1)
        h = h + gate[:, None, :] * self.mixer(modulate(h, shift, scale))
        if self.reverse:
            h = h.flip(1)
        return self._unorder(h)


class CrossAttentionFusion(nn.Module):
    def __init__(self, dim, prec, heads=8):
        super().__init__()
        half = dim // 2
        self.heads, self.prec = heads, prec
        self.qkv1 = Linear(half, 3 * half, prec)
        self.qkv2 = Linear(half, 3 * half, prec)
        self.proj = Linear(dim, dim, prec)

    def _split(self, qkv):
        B, L, W3 = qkv.shape
        return [t.reshape(B, L, self.heads, -1) for t in qkv.chunk(3, -1)]

    def forward(self, x1, x2):
        B, L, _ = x1.shape
        q1, k1, v1 = self._split(self.qkv1(x1))
        q2, k2, v2 = self._split(self.qkv2(x2))
        x12 = attention(q1, k2, v2, self.prec).reshape(B, L, -1)
        x21 = attention(q2, k1, v1, self.prec).reshape(B, L, -1)
        return self.proj(torch.cat([x12, x21], -1))


class GatedMLP(nn.Module):
    def __init__(self, dim, hidden, prec):
        super().__init__()
        self.w12 = Linear(dim, 2 * hidden, prec)
        self.w3 = Linear(hidden, dim, prec)

    def forward(self, x):
        a, b = self.w12(x).chunk(2, -1)
        return self.w3(gelu_tanh(a) * b)


class Mlp(nn.Module):
    def __init__(self, dim, hidden, prec):
        super().__init__()
        self.fc1 = Linear(dim, hidden, prec)
        self.fc2 = Linear(hidden, dim, prec)

    def forward(self, x):
        return self.fc2(gelu_tanh(self.fc1(x)))


class Norm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))


class Attention(nn.Module):
    def __init__(self, dim, heads, prec):
        super().__init__()
        self.heads, self.prec = heads, prec
        self.qkv = Linear(dim, 3 * dim, prec)
        self.proj = Linear(dim, dim, prec)

    def forward(self, x):
        B, L, D = x.shape
        q, k, v = (t.reshape(B, L, self.heads, -1)
                   for t in self.qkv(x).chunk(3, -1))
        return self.proj(attention(q, k, v, self.prec).reshape(B, L, D))


class DiTBlock(nn.Module):
    def __init__(self, dim, heads, prec, gated):
        super().__init__()
        self.attn = Attention(dim, heads, prec)
        self.mlp = GatedMLP(dim, 4 * dim, prec) if gated else \
            Mlp(dim, 4 * dim, prec)
        self.adaLN_modulation = Seq(dim, 6 * dim, prec)

    def forward(self, x, c):
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
         gate_mlp) = self.adaLN_modulation(c).chunk(6, -1)
        x = x + gate_msa[:, None, :] * self.attn(
            modulate(layer_norm(x), shift_msa, scale_msa))
        return x + gate_mlp[:, None, :] * self.mlp(
            modulate(layer_norm(x), shift_mlp, scale_mlp))


class CombinedBlock(nn.Module):
    """The published DiMSUM block: add + RMSNorm, the spatial half in
    raster (or column) order and the wavelet half in windowed order, the
    cross-attention fusion, the gated MLP under a 3-way adaLN."""

    def __init__(self, i, dim, prec):
        super().__init__()
        reverse, transpose = i % 2 > 0, i % 4 >= 2
        half = dim // 2
        self.norm = Norm(dim)
        self.spatial_mamba = MixerHalf(half, dim, prec, "raster", reverse,
                                       transpose)
        self.freq_mamba = MixerHalf(half, dim, prec, "wave", reverse,
                                    reverse)
        self.proj = CrossAttentionFusion(dim, prec)
        self.adaLN_modulation = Seq(dim, 3 * dim, prec)
        self.norm_2 = Norm(dim)
        self.mlp = GatedMLP(dim, 4 * dim, prec)

    def forward(self, x, residual, c, keep=None):
        """`keep` (B,) scales the incoming hidden states per sample
        (stochastic depth: 0 or 1 / (1 - rate)); None keeps them."""
        if keep is not None:
            x = x * keep[:, None, None]
        total = x if residual is None else x + residual
        h = rms_norm(total, self.norm.weight)
        x1, x2 = h.chunk(2, -1)
        fused = self.proj(self.spatial_mamba(x1, c), self.freq_mamba(x2, c))
        shift, scale, gate = self.adaLN_modulation(c).chunk(3, -1)
        h = h + fused
        moded = modulate(rms_norm(h, self.norm_2.weight), shift, scale)
        return h + gate[:, None, :] * self.mlp(moded), total


class Embed(nn.Module):
    """Patch, timestep and label embedders and the final layer, shared
    by both models; with `learn_sigma` the final layer gives twice the
    input's channels."""

    def __init__(self, cfg, prec):
        super().__init__()
        D, p, C = cfg["hidden_size"], cfg["patch_size"], cfg["in_channels"]
        self.p, self.C = p, C * (2 if cfg.get("learn_sigma") else 1)
        self.x_embedder = nn.Module()
        self.x_embedder.proj = nn.Module()
        self.x_embedder.proj.weight = nn.Parameter(torch.empty(D, C, p, p))
        self.x_embedder.proj.bias = nn.Parameter(torch.empty(D))
        self.t_embedder = nn.Module()
        self.t_embedder.mlp = nn.Module()
        self.t_embedder.mlp.add_module("0", Linear(256, D, prec))
        self.t_embedder.mlp.add_module("2", Linear(D, D, prec))
        self.y_embedder = nn.Module()
        self.y_embedder.embedding_table = nn.Module()
        self.y_embedder.embedding_table.weight = nn.Parameter(
            torch.empty(cfg["num_classes"] + 1, D))
        self.final_layer = nn.Module()
        self.final_layer.adaLN_modulation = Seq(D, 2 * D, prec)
        self.final_layer.linear = Linear(D, p * p * self.C, prec)
        self.prec = prec

    def embed(self, x, t, y):
        B, C, H, W = x.shape
        p = self.p
        patches = (x.reshape(B, C, H // p, p, W // p, p)
                   .permute(0, 2, 4, 1, 3, 5).reshape(B, -1, C * p * p))
        proj = self.x_embedder.proj
        tok = self.prec.linear(patches, proj.weight.reshape(
            proj.weight.shape[0], -1), proj.bias)
        half = 128
        freqs = torch.exp(-math.log(10000) * torch.arange(
            half, dtype=torch.float32, device=x.device) / half)
        args = t[:, None].float() * freqs[None]
        temb = torch.cat([torch.cos(args), torch.sin(args)], -1)
        mlp = self.t_embedder.mlp
        temb = getattr(mlp, "2")(F.silu(getattr(mlp, "0")(temb)))
        c = temb + self.y_embedder.embedding_table.weight[y]
        return tok, c

    def final(self, x, c):
        shift, scale = self.final_layer.adaLN_modulation(c).chunk(2, -1)
        x = self.final_layer.linear(modulate(layer_norm(x), shift, scale))
        N, T, _ = x.shape
        p, C = self.p, self.C
        s = int(round(T ** 0.5))
        x = x.reshape(N, s, s, p, p, C).permute(0, 5, 1, 3, 2, 4)
        return x.reshape(N, C, s * p, s * p)


class RefDiM(Embed):
    """DiM with "combined" blocks, CondMamba, RMSNorm, a learnable sin-cos
    position table and a shared DiT block after every k-th block."""

    def __init__(self, cfg, prec: Optional[Precision] = None):
        prec = prec or Precision()
        super().__init__(cfg, prec)
        D = cfg["hidden_size"]
        self.k = cfg["use_attn_every_k_layers"]
        L = (cfg["img_resolution"] // cfg["patch_size"]) ** 2
        self.pos_embed = nn.Parameter(torch.empty(1, L, D))
        self.blocks = nn.ModuleList([CombinedBlock(i, D, prec)
                                     for i in range(cfg["depth"])])
        self.attn_block = DiTBlock(D, cfg["num_heads"], prec, gated=True)

    def forward(self, x, t, y, keeps=None):
        """`keeps[i]` (B,) the stochastic-depth scale of block i's input
        (training); None in sampling."""
        h, c = self.embed(x, t, y)
        h = h + self.pos_embed
        residual = None
        for i, block in enumerate(self.blocks):
            h, residual = block(h, residual, c,
                                None if keeps is None else keeps[i])
            if (i + 1) % self.k == 0:
                h = self.attn_block(h, c)
        return self.final(h, c)


class RefDiT(Embed):
    def __init__(self, cfg, prec: Optional[Precision] = None):
        prec = prec or Precision()
        super().__init__(cfg, prec)
        D = cfg["hidden_size"]
        L = (cfg["img_resolution"] // cfg["patch_size"]) ** 2
        self.pos_embed = nn.Parameter(torch.empty(1, L, D))
        self.blocks = nn.ModuleList([
            DiTBlock(D, cfg["num_heads"], prec, gated=False)
            for _ in range(cfg["depth"])])

    def forward(self, x, t, y, keeps=None):
        h, c = self.embed(x, t, y)
        h = h + self.pos_embed
        for block in self.blocks:
            h = block(h, c)
        return self.final(h, c)


MODELS = {"dim": RefDiM, "dit": RefDiT}


def build(cfg, prec: Optional[Precision] = None) -> nn.Module:
    """The reference of configuration `cfg` (the `model` mapping of a
    configuration file), its parameters on the meta device: load a state
    dict with `assign=True`."""
    with torch.device("meta"):
        return MODELS[cfg["family"]](cfg, prec)


def sincos_pos_embed(D: int, grid_size: int) -> np.ndarray:
    """The 2-D sin-cos position table (L, D), the w-coordinate half
    first, as the published models make it."""
    def one(dim, pos):
        omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64)
                                / (dim / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    g = np.arange(grid_size, dtype=np.float32)
    gw, gh = np.meshgrid(g, g)
    return np.concatenate([one(D // 2, gw), one(D // 2, gh)],
                          axis=1).astype(np.float32)

