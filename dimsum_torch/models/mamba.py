"""Mamba / CondMamba selective-SSM mixer, port of
`dimsum_tpu/models/mamba.py` for scan_type "none":

  in_proj -> [x | z] -> depthwise causal conv + SiLU -> x_proj ->
  (dt_low, B, C) -> selective scan with dt = dt_low @ dt_proj.weight^T
  expanded in the kernel, dt_proj.bias, softplus, D skip and silu(z) gate
  -> out_proj

CondMamba's `cond_proj` is created for checkpoint parity and stays out of
the graph, as in the reference's fast path.  Reversed token order is done
by the caller's flips (the blocks), so the mixer only runs forward in time.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from dimsum_torch.models.linear import Linear
from dimsum_torch.ops.causal_conv1d import causal_conv1d
from dimsum_torch.ops.selective_scan import selective_scan_dtlow


class Mamba(nn.Module):
    """Set `d_cond` for the CondMamba variant (adds `cond_proj`).

    `scan_impl` (an attribute) picks the selective scan: None, the kernel
    for CUDA tensors and the plain version for CPU tensors; "ref", the plain
    version on any device, which checks hold the kernel against."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4,
                 expand: int = 2, dt_rank: Optional[int] = None,
                 d_cond: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_inner = d_inner = expand * d_model
        self.d_state = d_state
        self.dt_rank = math.ceil(d_model / 16) if dt_rank is None else dt_rank
        self.scan_impl: Optional[str] = None
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
        x_conv = causal_conv1d(x_in, self.conv1d.weight[:, 0, :],
                               self.conv1d.bias, activation="silu")
        r, n = self.dt_rank, self.d_state
        dt_low, Bm, Cm = self.x_proj(x_conv).split([r, n, n], dim=-1)
        dt_w = self.dt_proj.weight.t().to(dt_low.dtype).contiguous()
        A = -torch.exp(self.A_log.float())
        y = selective_scan_dtlow(
            x_conv, dt_low.contiguous(), dt_w, A, Bm.contiguous(),
            Cm.contiguous(), self.D, z=z.contiguous(),
            delta_bias=self.dt_proj.bias, delta_softplus=True,
            impl=self.scan_impl)
        return self.out_proj(y)


CondMamba = Mamba
