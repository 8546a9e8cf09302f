"""Stable-Diffusion VAE (AutoencoderKL, f8, 4-channel latents), port of
`dimsum_tpu/models/vae.py`, under the diffusers module and key layout
(`encoder.down_blocks.{i}.resnets.{j}.conv1.weight`,
`decoder.mid_block.attentions.0.to_out.0.weight`, ...), so a diffusers
`AutoencoderKL` state dict (`stabilityai/sd-vae-ft-{ema,mse}`) loads as it
is.  The JAX package reads the same dict through `convert_diffusers_vae`.

As the reference: GroupNorm(32) with eps 1e-6; the downsampler pads by
(0, 1) on each spatial axis and takes a stride-2 3x3 conv without padding;
the upsampler is nearest x2 then a 3x3 conv; the mid attention is one head
over all C channels, scaled by 1/sqrt(C); the posterior's logvar is clipped
to (-30, 20); latents are scaled by 0.18215.  Decode runs in fp32 by
default (bf16 decode shifts FID).  No Pallas kernel runs in the JAX VAE, so
the port uses PyTorch's convolutions, GroupNorm and attention.

Weights load from a local file only (`load_vae`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dimsum_torch.utils.device import resolve_device

SD_SCALE_FACTOR = 0.18215


def _norm(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, ch, eps=1e-6)


class ResnetBlock2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = _norm(in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = _norm(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_ch, out_ch, 1)
                              if in_ch != out_ch else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """Single-head self-attention over the H x W positions, residual."""

    def __init__(self, ch: int):
        super().__init__()
        self.group_norm = _norm(ch)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).reshape(B, C, H * W).transpose(1, 2)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        h = F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None],
                                           scale=1.0 / math.sqrt(C))[:, 0]
        h = self.to_out[0](h).transpose(1, 2).reshape(B, C, H, W)
        return x + h


class Downsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class MidBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(ch, ch),
                                      ResnetBlock2D(ch, ch)])
        self.attentions = nn.ModuleList([Attention(ch)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class _Level(nn.Module):
    """One resolution: `n` resnets, then a resampler (`downsamplers` or
    `upsamplers`, as diffusers names them) unless it is the last."""

    def __init__(self, in_ch, out_ch, n, resample: Optional[type],
                 attr: str):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(in_ch if j == 0 else
                                                    out_ch, out_ch)
                                      for j in range(n)])
        self.attr = attr
        if resample is not None:
            setattr(self, attr, nn.ModuleList([resample(out_ch)]))

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if hasattr(self, self.attr):
            x = getattr(self, self.attr)[0](x)
        return x


class Encoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 z_ch: int = 4, in_ch: int = 3):
        super().__init__()
        self.conv_in = nn.Conv2d(in_ch, ch, 3, padding=1)
        chans = [ch * m for m in ch_mult]
        last = len(chans) - 1
        ins = [ch] + chans[:-1]
        self.down_blocks = nn.ModuleList([
            _Level(ins[i], c, 2,
                   Downsample2D if i < last else None, "downsamplers")
            for i, c in enumerate(chans)])
        self.mid_block = MidBlock(chans[-1])
        self.conv_norm_out = _norm(chans[-1])
        self.conv_out = nn.Conv2d(chans[-1], 2 * z_ch, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            h = block(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 z_ch: int = 4, out_ch: int = 3):
        super().__init__()
        chans = [ch * m for m in reversed(ch_mult)]
        last = len(chans) - 1
        self.conv_in = nn.Conv2d(z_ch, chans[0], 3, padding=1)
        self.mid_block = MidBlock(chans[0])
        self.up_blocks = nn.ModuleList([
            _Level(chans[max(i - 1, 0)], c, 3,
                   Upsample2D if i < last else None, "upsamplers")
            for i, c in enumerate(chans)])
        self.conv_norm_out = _norm(chans[-1])
        self.conv_out = nn.Conv2d(chans[-1], out_ch, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            h = block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """encode: images in [-1, 1], NCHW -> scaled latents (B, z, H/f, W/f);
    decode: scaled latents -> images in [-1, 1]; f = 2^(len(ch_mult) - 1).
    Runs in the dtype of its weights (fp32 unless cast)."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 z_ch: int = 4):
        super().__init__()
        self.encoder = Encoder(ch, ch_mult, z_ch)
        self.decoder = Decoder(ch, ch_mult, z_ch)
        self.quant_conv = nn.Conv2d(2 * z_ch, 2 * z_ch, 1)
        self.post_quant_conv = nn.Conv2d(z_ch, z_ch, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.quant_conv.weight.dtype

    def encode_moments(self, x):
        """(mean, logvar) of the latent posterior, logvar clipped to
        (-30, 20)."""
        moments = self.quant_conv(self.encoder(x.to(self.dtype)))
        mean, logvar = moments.chunk(2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode(self, x, generator: Optional[torch.Generator] = None,
               noise=None):
        """A draw from the posterior times 0.18215 (the reference's
        `.latent_dist.sample().mul_(0.18215)`); `noise` (a standard normal
        tensor of the latent's shape) replaces the draw from
        `generator`."""
        mean, logvar = self.encode_moments(x)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator,
                                device=mean.device, dtype=mean.dtype)
        z = mean + torch.exp(0.5 * logvar) * noise.to(mean)
        return z * SD_SCALE_FACTOR

    def decode(self, z):
        """z is the scaled latent; returns images in [-1, 1], NCHW."""
        z = (z / SD_SCALE_FACTOR).to(self.dtype)
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return self.decode(self.encode(x, generator))


@torch.no_grad()
def random_init_vae_(vae: AutoencoderKL, seed: int) -> AutoencoderKL:
    """Seeded random weights: every conv and linear U(+-1/sqrt(fan_in)),
    biases 0, norms 1 and 0.  The JAX package's flax init cannot be
    reproduced here; tests hold the two on converted weights instead."""
    dev = next(vae.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    for m in vae.modules():
        if isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, (nn.Conv2d, nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=g)
            m.bias.zero_()
    return vae


def _read_state_dict(path: str):
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(
                f"{path}: reading .safetensors needs the `safetensors` "
                "package, which is not installed; convert the file to a "
                "torch .bin/.pt state dict") from e
        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def architecture(state_dict) -> dict:
    """AutoencoderKL's arguments (ch, ch_mult, z_ch) read from a diffusers
    state dict's shapes: SD's VAE gives ch 128, ch_mult (1, 2, 4, 4)."""
    ch = state_dict["encoder.conv_in.weight"].shape[0]
    levels = 0
    while f"encoder.down_blocks.{levels}.resnets.0.conv1.weight" in state_dict:
        levels += 1
    ch_mult = tuple(
        state_dict[f"encoder.down_blocks.{i}.resnets.0.conv2.weight"].shape[0]
        // ch for i in range(levels))
    return dict(ch=ch, ch_mult=ch_mult,
                z_ch=state_dict["post_quant_conv.weight"].shape[0])


def load_vae(path: str, device="cuda") -> AutoencoderKL:
    """The VAE on `device` (the card unless the caller asks for the CPU),
    in eval mode, from a local diffusers state dict (`.bin` or `.pt`;
    `.safetensors` needs the `safetensors` package), loaded strictly, with
    the architecture its shapes give (`architecture`).  Older checkpoints'
    1x1-conv attention weights are taken as linear ones.

    `"random"` or `"random:<seed>"` gives the SD-VAE (ch 128, ch_mult
    1 2 4 4) with the port's seeded random weights (`random_init_vae_`):
    a fixed latent <-> pixel map for running the pipeline where no weights
    are on disk."""
    dev = resolve_device(device)
    if path == "random" or path.startswith("random:"):
        seed = int(path.split(":", 1)[1]) if ":" in path else 0
        with torch.device(dev):
            vae = AutoencoderKL()
        return random_init_vae_(vae, seed).eval()
    sd = {k: (v[:, :, 0, 0] if v.ndim == 4 and ".attentions." in k
              and k.endswith("weight") else v).float()
          for k, v in _read_state_dict(path).items()}
    with torch.device(dev):
        vae = AutoencoderKL(**architecture(sd))
    vae.load_state_dict(sd, strict=True)
    return vae.eval()
