"""What one call of a cell asks of the card, counted from its shapes: the
model's FLOPs (2 x the multiply-adds of every matmul, convolution and
attention product, the calflops convention; elementwise work, norms and
the scan's recurrence not counted) and the least time of the work each of
the port's hand-written kernels does in a call, summed over the sites of
the configuration that the kernels take (`bounds.py` at each site's
shapes), with the launches that work takes.  A training step counts 3
forwards; recomputation is not counted."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from perfbench.counts import bounds as B


def _dims(cfg):
    D, p = cfg["hidden_size"], cfg["patch_size"]
    L = (cfg["img_resolution"] // p) ** 2
    return D, p, L, cfg["in_channels"]


def out_channels(cfg) -> int:
    """The final layer's channels: twice the input's with a learned
    variance."""
    return cfg["in_channels"] * (2 if cfg.get("learn_sigma") else 1)


def dim_mixer(cfg):
    """(d_model, d_inner, dt_rank, d_state, d_conv) of a DiM half's
    mixer."""
    half = cfg["hidden_size"] // 2
    d_inner = cfg["expand"] * half
    return half, d_inner, math.ceil(half / 16), cfg["d_state"], cfg["d_conv"]


def forward_macs(cfg) -> int:
    """Multiply-adds of one row's forward."""
    D, p, L, C = _dims(cfg)
    macs = L * C * p * p * D + 256 * D + D * D          # patch, timestep
    macs += 2 * D * D + L * D * p * p * out_channels(cfg)  # final layer
    dit = (6 * D * D + 3 * L * D * D + 2 * L * L * D + L * D * D)
    if cfg["family"] == "dit":
        mlp = 2 * L * D * 4 * D                          # fc1, fc2
        return macs + cfg["depth"] * (dit + mlp)
    h, di, r, n, w = dim_mixer(cfg)
    mixer = (D * 3 * h + L * h * 2 * di + L * di * w + L * di * (r + 2 * n)
             + L * r * di + L * di * h)
    fusion = 2 * L * h * 3 * h + 4 * L * L * h + L * D * D
    gated = L * D * 8 * D + L * 4 * D * D                # w12, w3
    block = 2 * mixer + fusion + 3 * D * D + gated
    n_attn = cfg["depth"] // cfg["use_attn_every_k_layers"]
    return macs + cfg["depth"] * block + n_attn * (dit + gated)


def call_flops(cell, cfg) -> float:
    """Model FLOPs of one timed call: a CFG drift call's rows, or a
    training step's rows three times."""
    flops = 2.0 * forward_macs(cfg)
    if cell["entry"] == "train":
        return 3.0 * cell["batch"] * flops
    return 2 * cell["images"] * flops


def _norm_sites(cfg, R, L, D):
    """The calls that the add + norm and norm + modulate kernels take in
    one forward, as (count, flags) with `bounds.norm_bound`'s flags: x
    and the modulation in bf16, the residual and its total in fp32."""
    sw = cfg["switches"]
    fused = sw.get("fused_norm", False)
    sites = []
    mod_only = dict(shift=2, scale=2, total=2, rms=False)     # h1, final
    if cfg["family"] == "dit":
        if fused:
            sites += [(cfg["depth"], mod_only),
                      (cfg["depth"], dict(branch=2, gate=2, shift=2,
                                          scale=2, total=2, rms=False)),
                      (1, mod_only)]
        return sites
    k = cfg["use_attn_every_k_layers"]
    depth = cfg["depth"]
    tail = sw.get("pending_tail", 0)
    after_attn = sum(1 for i in range(1, depth) if i % k == 0)
    if sw.get("pallas_norm", False):
        tops = after_attn if tail else depth - 1
        sites.append((tops, dict(res=4, total=4, w=4, rms=True)))
    if tail == 2:
        sites.append((depth - 1 - after_attn,
                      dict(branch=2, gate=2, res=4, total=4, w=4,
                           rms=True)))
    if fused:
        sites += [(depth, dict(branch=2, shift=2, scale=2, total=2, w=4,
                               rms=True)),
                  (depth // k, mod_only),
                  (depth // k, dict(branch=2, gate=2, shift=2, scale=2,
                                    total=2, rms=False)),
                  (1, mod_only)]
    return sites


class Bound(NamedTuple):
    """One call's work in a kernel group: its least seconds, summed over
    the sites, and the launches of the group's kernels that work takes."""
    seconds: float
    launches: int


# launches a site takes: the training forward's state pass and main pass,
# and the backward's carry pass and main pass
LAUNCHES_PER_SITE = {"scan": 1, "scan_train": 4, "conv_xproj": 1,
                     "attention": 1, "norm": 1}


def kernel_bounds(cell, cfg) -> dict:
    """{kernel group: Bound} for the groups this cell runs: "scan"
    (inference) or "scan_train" (the training forward and backward),
    "conv_xproj", "attention" (the full-block kernel, L >= 1024) and
    "norm" (add + norm and norm + modulate)."""
    D, p, L, C = _dims(cfg)
    train = cell["entry"] == "train"
    R = cell["batch"] if train else 2 * cell["images"]
    bf16 = torch.bfloat16
    out = {}

    def put(group, sites, ms):
        out[group] = Bound(ms / 1e3, sites * LAUNCHES_PER_SITE[group])

    if cfg["family"] == "dim":
        h, di, r, n, w = dim_mixer(cfg)
        mixers = 2 * cfg["depth"]
        x = B.scan_args(R, L, di, n, r, bf16)
        if train:
            tb = B.train_bounds(x, B.TRAIN_CHUNK)
            put("scan_train", mixers,
                mixers * (tb["fwd_train"][0] + tb["bwd"][0]))
        else:
            put("scan", mixers, mixers * B.scan_bound(x)[0])
            if cfg["switches"].get("conv_xproj", False):
                put("conv_xproj", mixers, mixers * B.convx_bound(
                    R, L, di, w, r + 2 * n, 2, B.BF16_TC_FLOP_PER_S)[0])
        if L >= 1024:
            n_attn = cfg["depth"] // cfg["use_attn_every_k_layers"]
            put("attention", n_attn + 2 * cfg["depth"],
                n_attn * B.attn_bound(R, L, cfg["num_heads"],
                                      D // cfg["num_heads"], bf16)[0]
                + 2 * cfg["depth"] * B.attn_bound(R, L, 8, h // 8, bf16)[0])
    else:
        H = cfg["num_heads"]
        put("attention", cfg["depth"],
            cfg["depth"] * B.attn_bound(R, L, H, D // H, bf16)[0])
    if not train:
        sites = _norm_sites(cfg, R, L, D)
        if sites:
            put("norm", sum(c for c, _ in sites),
                sum(c * B.norm_bound(R * L * D, R, D, 2, f)[0]
                    for c, f in sites))
    return out
