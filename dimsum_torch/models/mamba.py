"""Mamba / CondMamba selective-SSM mixer, port of
`dimsum_tpu/models/mamba.py`:

  in_proj -> [x | z] -> depthwise causal conv + SiLU -> x_proj ->
  (dt_low, B, C) -> selective scan with dt = dt_low @ dt_proj.weight^T
  expanded in the kernel, dt_proj.bias, softplus, D skip and silu(z) gate
  -> out_proj

CondMamba's `cond_proj` is created for checkpoint parity and stays out of
the graph, as in the reference's fast path, unless `use_cond_init` (the
JAX option, mamba.py:234-250) seeds every branch's scan state from it:
h0 = cond_proj(c)[:, :, None] * 1_N in fp32 (the state before step 0);
a reversed branch then runs between explicit flips of its input and
output, as in JAX (mamba.py:153-157), and sequence parallelism raises
(mamba.py:241-245).  Without `d_cond` the mixer is plain Mamba (no
`cond_proj`).

Scan types (the JAX `scan_type`, mamba.py:282-333):

  * "none": one branch, forward in time.
  * "v2": a second parameter set (`A_b_log`, `conv1d_b`, `x_proj_b`,
    `dt_proj_b`, `D_b`, the reference's names) runs the same branch in
    reversed time (an anticausal conv and the reverse-time scan), and the
    two outputs are summed before out_proj.
  * zigzag ("zigma_<n>", "sweep_<n>", "jpeg_<n>"): in_proj's output is
    gathered by the layer's permutation (row `layer_idx` of
    `zigzag_paths`) before the conv, and out_proj's output by its inverse.

`forward(..., reverse_tokens=True)` runs the mixer in reversed token
order, flip_L(mixer(flip_L(x))), with no flip: the conv runs anticausal
and the scan in reversed time (on the card, the scan kernel's reverse
entry; with v2 the two branches swap directions).  Zigzag with
`reverse_tokens` raises, as in JAX (mamba.py:286-290).

With `seq_group` (a `torch.distributed` process group; the JAX `seq_axis`)
the conv and the scan run sequence-parallel over its ranks, in the JAX
package's two modes (mamba.py:166-181, :256-268):

  * mixer level (`seq_island=False`): x is already this rank's L-shard (the
    JAX mixer inside a `shard_map`), and so is the output;
  * island (`seq_island=True`, the JAX `seq_mesh`; `DiMConfig.seq_group`
    sets it in every mixer): x is the whole sequence on every rank; the
    mixer takes its rank's L-slice of x_in and z after in_proj, and
    all-gathers the scan output along L before out_proj.

Either way: the halo conv (`causal_conv1d_halo`), x_proj, dt = dt_low @
dt_proj.weight^T materialized in the compute dtype (mamba.py:252, not the
fp32 expansion inside the scan kernel of the single-rank route), then the
two-pass scan (`selective_scan_seq_parallel`); `reverse_tokens` there is
flips around it, as JAX falls back to (mamba.py:143-147).  As in the JAX
`elif` chain, the halo branch comes before the fused `conv_xproj`.  Forward
only: with a parameter that needs a gradient it raises.  v2 and zigzag
with `seq_group` raise, as in JAX (mamba.py:291-295).

With `tp_group` (tensor parallelism, `DiMConfig.tp_group`; the JAX
`tp_param_specs` rules under GSPMD) the mixer holds its rank's d_inner / k
channels (`parallel/mesh.py::TP_RULES`): in_proj's rows of both halves
(the rank's x and z channels), conv1d, dt_proj, A_log and D cut by channel,
x_proj's and out_proj's columns.  The input enters by `tp_copy`; x_proj's
product on the rank's channels is a partial x_dbl, summed over the group
(`tp_sum_sharded`) before dt_low, B and C are cut from it (after the
conv + x_proj kernel's fp32 product, with `conv_xproj`); out_proj's
partial outputs are summed (`tp_sum`).  The scan kernels and the conv +
x_proj kernel run on the rank's channels as on a narrower mixer; h0 (from
the replicated cond_proj) is cut to them.  With `seq_group` it raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from dimsum_torch.models.linear import Linear
from dimsum_torch.ops.causal_conv1d import causal_conv1d, causal_conv1d_halo
from dimsum_torch.ops.conv_xproj import conv_xproj, conv_xproj_supported
from dimsum_torch.ops.selective_scan import selective_scan_dtlow
from dimsum_torch.ops.selective_scan_sp import selective_scan_seq_parallel
from dimsum_torch.parallel.mesh import (all_gather, tp_copy, tp_rank,
                                        tp_size, tp_sum, tp_sum_sharded)
from dimsum_torch.utils import remat


def is_zigzag(scan_type: str) -> bool:
    """True for the zigzag scan types, "<zoo>_<n>" of the path zoo."""
    return (scan_type or "none").split("_")[0] in ("zigma", "sweep", "jpeg")


class Mamba(nn.Module):
    """Set `d_cond` for the CondMamba variant (adds `cond_proj`).

    `conv_xproj` (the JAX `DIMSUM_CONV_XPROJ`) computes the conv, SiLU and
    x_proj in one fused op (`ops/conv_xproj.py`) where the JAX gate's shape
    test holds (mamba.py:187-192), in either direction; the parameters keep
    their names.

    `scan_impl` and `conv_impl` (attributes) pick the selective scan and
    the fused conv: None, the kernel for CUDA tensors and the plain version
    for CPU tensors; "ref", the plain version on any device, which checks
    hold the kernels against."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4,
                 expand: int = 2, dt_rank: Optional[int] = None,
                 d_cond: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 conv_xproj: bool = False, seq_group=None,
                 seq_island: bool = False, scan_type: str = "none",
                 layer_idx: int = 0, zigzag_paths=None,
                 zigzag_paths_reverse=None, use_cond_init: bool = False,
                 tp_group=None):
        super().__init__()
        k = tp_size(tp_group)
        if (expand * d_model) % k:
            raise ValueError(f"d_inner {expand * d_model} does not split "
                             f"over {k} tensor-parallel ranks")
        if tp_group is not None and seq_group is not None:
            raise NotImplementedError(
                "tensor and sequence parallelism together: no JAX CLI "
                "builds that mesh")
        self.tp_group = tp_group
        self.d_inner = d_inner = expand * d_model // k
        self.d_state = d_state
        self.dt_rank = math.ceil(d_model / 16) if dt_rank is None else dt_rank
        self.conv_xproj = conv_xproj
        self.seq_group, self.seq_island = seq_group, seq_island
        self.scan_type = scan_type
        self.use_cond_init = use_cond_init and d_cond is not None
        self.scan_impl: Optional[str] = None
        self.conv_impl: Optional[str] = None
        zig = is_zigzag(scan_type)
        if seq_group is not None and (zig or scan_type == "v2"):
            raise NotImplementedError(
                "seq_group supports scan_type 'none' only: zigzag gathers "
                "and the v2 flip are global token permutations, which a "
                "sequence-sharded mixer cannot apply locally")
        self.in_proj = Linear(d_model, 2 * d_inner, bias=False, dtype=dtype)
        for suffix in ("", "_b") if scan_type == "v2" else ("",):
            self._add_branch(suffix, d_conv, dtype)
        self.out_proj = Linear(d_inner, d_model, bias=False, dtype=dtype)
        if d_cond is not None:  # whole on every rank (no TP rule)
            self.cond_proj = Linear(d_cond, d_inner * k, dtype=dtype)
        if zig:
            # the layer's permutation and its inverse (not in the state
            # dict: the reference's frozen zigzag buffers are regenerated)
            for name, paths in (("perm", zigzag_paths),
                                ("perm_rev", zigzag_paths_reverse)):
                self.register_buffer(name, torch.as_tensor(
                    paths[layer_idx], dtype=torch.long), persistent=False)

    def _add_branch(self, suffix: str, d_conv: int, dtype):
        """One direction's parameters under the reference's names: conv1d,
        x_proj, dt_proj, A_log, D (with `suffix` "_b": conv1d_b, ...,
        A_b_log, D_b)."""
        d_inner, n = self.d_inner, self.d_state
        setattr(self, f"conv1d{suffix}", nn.Conv1d(
            d_inner, d_inner, d_conv, groups=d_inner, padding=d_conv - 1))
        setattr(self, f"x_proj{suffix}", Linear(
            d_inner, self.dt_rank + 2 * n, bias=False, dtype=dtype))
        # used through its weight and bias only: the scan expands dt itself
        setattr(self, f"dt_proj{suffix}", nn.Linear(self.dt_rank, d_inner))
        setattr(self, f"A{suffix}_log", nn.Parameter(torch.log(torch.arange(
            1, n + 1, dtype=torch.float32).repeat(d_inner, 1))))
        setattr(self, f"D{suffix}", nn.Parameter(torch.ones(d_inner)))

    def forward(self, x, cond_emb=None, reverse_tokens: bool = False):
        """x: (B, L, d_model); cond_emb (B, d_cond) seeds the scans with
        `use_cond_init` and is unused otherwise (see the module docstring);
        `reverse_tokens` runs the mixer in reversed token order."""
        zig = is_zigzag(self.scan_type)
        if reverse_tokens and zig:
            raise NotImplementedError(
                "reverse_tokens composes with zigzag gathers only through "
                "explicit flips; apply the flip at the block level instead")
        xz = self.in_proj(tp_copy(x, self.tp_group))
        if zig:
            xz = xz.index_select(1, self.perm)
        x_in, z = xz.chunk(2, dim=-1)
        h0 = None
        if self.use_cond_init and cond_emb is not None:
            if self.seq_group is not None:
                # each shard would seed its own walk with h0: refused, as
                # in JAX
                raise NotImplementedError(
                    "use_cond_init h0 seeding is not supported with "
                    "sequence parallelism: h0 must enter on shard 0 only "
                    "and be carried across shards")
            cond = tp_copy(self.cond_proj(cond_emb), self.tp_group)
            if self.tp_group is not None:
                r0 = tp_rank(self.tp_group) * self.d_inner
                cond = cond[:, r0:r0 + self.d_inner]
            h0 = cond.float()[:, :, None].expand(
                -1, -1, self.d_state).contiguous()
        if self.seq_group is not None:
            if reverse_tokens:
                y = self._seq_parallel(x_in.flip(1), z.flip(1)).flip(1)
            else:
                y = self._seq_parallel(x_in, z)
            return self.out_proj(y)
        y = self._branch(x_in, z, "", reverse_tokens, h0)
        if self.scan_type == "v2":
            # with reverse_tokens the roles swap: "" runs reversed, "_b"
            # forward (the reference's flip(mixer_v2(flip(x))))
            y = y + self._branch(x_in, z, "_b", not reverse_tokens, h0)
        out = tp_sum(self.out_proj(y), self.tp_group)
        if zig:
            out = out.index_select(1, self.perm_rev)
        return out

    def _branch(self, x_in, z, suffix: str, reverse: bool, h0=None):
        """conv -> x_proj -> selective scan of one direction: with
        `reverse`, flip_L(branch(flip_L(x))) from an anticausal conv and
        the reverse-time scan, or with `h0` (the seed of the scan state)
        between explicit flips."""
        if reverse and h0 is not None:
            return self._branch(x_in.flip(1), z.flip(1), suffix, False,
                                h0).flip(1)
        conv1d = getattr(self, f"conv1d{suffix}")
        x_proj = getattr(self, f"x_proj{suffix}")
        dt_proj = getattr(self, f"dt_proj{suffix}")
        r, n = self.dt_rank, self.d_state
        conv_w = conv1d.weight[:, 0, :]
        if self.conv_xproj and conv_xproj_supported(x_in, r + 2 * n):
            # the JAX `_XProj`: x_dbl in fp32, cast to the compute dtype
            x_conv, x_dbl = conv_xproj(x_in, conv_w, conv1d.bias,
                                       x_proj.weight, reverse=reverse,
                                       impl=self.conv_impl)
            x_dbl = tp_sum_sharded(x_dbl, self.tp_group)
            x_dbl = x_dbl.to(x_proj.compute_dtype)
        else:
            with remat.tag("conv_out"):  # a remat site, as ConvXProjFn
                x_conv = causal_conv1d(x_in, conv_w, conv1d.bias,
                                       activation="silu", reverse=reverse)
            x_dbl = tp_sum_sharded(x_proj(x_conv), self.tp_group)
        dt_low, Bm, Cm = x_dbl.split([r, n, n], dim=-1)
        dt_w = dt_proj.weight.t().to(dt_low.dtype).contiguous()
        A = -torch.exp(getattr(self, f"A{suffix}_log").float())
        return selective_scan_dtlow(
            x_conv, dt_low.contiguous(), dt_w, A, Bm.contiguous(),
            Cm.contiguous(), getattr(self, f"D{suffix}"), z=z.contiguous(),
            delta_bias=dt_proj.bias, delta_softplus=True, reverse=reverse,
            impl=self.scan_impl, h0=h0)

    def _seq_parallel(self, x_in, z):
        """halo conv -> x_proj -> dt in the compute dtype -> two-pass scan
        over `seq_group`; in island mode on this rank's L-slice, the
        output gathered along L."""
        if torch.is_grad_enabled() and any(
                p.requires_grad for p in self.parameters()):
            raise NotImplementedError(
                "sequence parallelism is forward only (ROADMAP Queue 1 "
                "item 8): run it under torch.no_grad()")
        group = self.seq_group
        if self.seq_island:
            k, my = dist.get_world_size(group), dist.get_rank(group)
            if x_in.shape[1] % k:
                raise ValueError(f"L = {x_in.shape[1]} does not split into "
                                 f"{k} sequence shards")
            s = x_in.shape[1] // k
            x_in, z = x_in[:, my * s:(my + 1) * s], z[:, my * s:(my + 1) * s]
        r, n = self.dt_rank, self.d_state
        x_conv = causal_conv1d_halo(x_in, self.conv1d.weight[:, 0, :],
                                    self.conv1d.bias, activation="silu",
                                    group=group)
        dt_low, Bm, Cm = self.x_proj(x_conv).split([r, n, n], dim=-1)
        dt = dt_low @ self.dt_proj.weight.t().to(dt_low.dtype)
        y = selective_scan_seq_parallel(
            x_conv, dt, -torch.exp(self.A_log.float()), Bm.contiguous(),
            Cm.contiguous(), self.D, z=z.contiguous(),
            delta_bias=self.dt_proj.bias, delta_softplus=True, group=group,
            impl=self.scan_impl)
        if self.seq_island:
            y = torch.cat(all_gather(y, group), dim=1)
        return y


CondMamba = Mamba
