"""Mamba / CondMamba selective-SSM mixer, port of
`dimsum_tpu/models/mamba.py` for scan_type "none":

  in_proj -> [x | z] -> depthwise causal conv + SiLU -> x_proj ->
  (dt_low, B, C) -> selective scan with dt = dt_low @ dt_proj.weight^T
  expanded in the kernel, dt_proj.bias, softplus, D skip and silu(z) gate
  -> out_proj

CondMamba's `cond_proj` is created for checkpoint parity and stays out of
the graph, as in the reference's fast path.  Reversed token order is done
by the caller's flips (the blocks), so the mixer only runs forward in time.

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
two-pass scan (`selective_scan_seq_parallel`).  As in the JAX `elif`
chain, the halo branch comes before the fused `conv_xproj`.  Forward only:
with a parameter that needs a gradient it raises.
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
from dimsum_torch.parallel.mesh import all_gather
from dimsum_torch.utils import remat


class Mamba(nn.Module):
    """Set `d_cond` for the CondMamba variant (adds `cond_proj`).

    `conv_xproj` (the JAX `DIMSUM_CONV_XPROJ`) computes the conv, SiLU and
    x_proj in one fused op (`ops/conv_xproj.py`) where the JAX gate's shape
    test holds (mamba.py:187-192); the parameters keep their names.

    `scan_impl` and `conv_impl` (attributes) pick the selective scan and
    the fused conv: None, the kernel for CUDA tensors and the plain version
    for CPU tensors; "ref", the plain version on any device, which checks
    hold the kernels against."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4,
                 expand: int = 2, dt_rank: Optional[int] = None,
                 d_cond: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 conv_xproj: bool = False, seq_group=None,
                 seq_island: bool = False):
        super().__init__()
        self.d_inner = d_inner = expand * d_model
        self.d_state = d_state
        self.dt_rank = math.ceil(d_model / 16) if dt_rank is None else dt_rank
        self.conv_xproj = conv_xproj
        self.seq_group, self.seq_island = seq_group, seq_island
        self.scan_impl: Optional[str] = None
        self.conv_impl: Optional[str] = None
        self.in_proj = Linear(d_model, 2 * d_inner, bias=False, dtype=dtype)
        self.conv1d = nn.Conv1d(d_inner, d_inner, d_conv, groups=d_inner,
                                padding=d_conv - 1)
        self.x_proj = Linear(d_inner, self.dt_rank + 2 * d_state,
                             bias=False, dtype=dtype)
        # used through its weight and bias only: the scan expands dt itself
        self.dt_proj = nn.Linear(self.dt_rank, d_inner)
        self.A_log = nn.Parameter(torch.log(torch.arange(
            1, d_state + 1, dtype=torch.float32).repeat(d_inner, 1)))
        self.D = nn.Parameter(torch.ones(d_inner))
        self.out_proj = Linear(d_inner, d_model, bias=False, dtype=dtype)
        if d_cond is not None:
            self.cond_proj = Linear(d_cond, d_inner, dtype=dtype)

    def forward(self, x, cond_emb=None):
        """x: (B, L, d_model).  cond_emb is accepted and unused (see the
        module docstring)."""
        x_in, z = self.in_proj(x).chunk(2, dim=-1)
        if self.seq_group is not None:
            return self.out_proj(self._seq_parallel(x_in, z))
        r, n = self.dt_rank, self.d_state
        conv_w = self.conv1d.weight[:, 0, :]
        if self.conv_xproj and conv_xproj_supported(x_in, r + 2 * n):
            # the JAX `_XProj`: x_dbl in fp32, cast to the compute dtype
            x_conv, x_dbl = conv_xproj(x_in, conv_w, self.conv1d.bias,
                                       self.x_proj.weight,
                                       impl=self.conv_impl)
            x_dbl = x_dbl.to(self.x_proj.compute_dtype)
        else:
            with remat.tag("conv_out"):  # a remat site, as ConvXProjFn
                x_conv = causal_conv1d(x_in, conv_w, self.conv1d.bias,
                                       activation="silu")
            x_dbl = self.x_proj(x_conv)
        dt_low, Bm, Cm = x_dbl.split([r, n, n], dim=-1)
        dt_w = self.dt_proj.weight.t().to(dt_low.dtype).contiguous()
        A = -torch.exp(self.A_log.float())
        y = selective_scan_dtlow(
            x_conv, dt_low.contiguous(), dt_w, A, Bm.contiguous(),
            Cm.contiguous(), self.D, z=z.contiguous(),
            delta_bias=self.dt_proj.bias, delta_softplus=True,
            impl=self.scan_impl)
        return self.out_proj(y)

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
