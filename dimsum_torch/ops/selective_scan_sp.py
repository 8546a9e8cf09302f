"""Sequence-parallel selective scan, port of
`dimsum_tpu/ops/selective_scan_sp.py`: L split over the ranks of a
`torch.distributed` process group, each rank holding one L-shard in rank
order.

  1. a local pass from a zero state returns the shard's last state h_last;
     the shard's total decay needs no scan: a_prod = exp(A * sum_t dt_t);
  2. one all_gather of the (a_prod, h_last) summaries ((K, 2, B, D, N),
     fp32) and an exclusive fold give each shard its incoming state
     h0_k = sum_{j<k} (prod_{j<i<k} a_i) h_j;
  3. a second local pass seeded with h0_k gives the exact outputs.

Both passes take `selective_scan_state`: on CUDA tensors its kernel (the
port of `_scan_kernel_with_state` and of `_scan_body`'s h0 case), on CPU
tensors its plain version.  Forward only, as the JAX package reaches its
kernels under SP only on the inference route.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from dimsum_torch.ops.selective_scan import selective_scan_state, softplus
from dimsum_torch.parallel.mesh import all_gather

__all__ = ["selective_scan_seq_parallel"]


def selective_scan_seq_parallel(u, delta, A, B, C, D=None, z=None,
                                delta_bias=None, delta_softplus=False,
                                group=None, impl: Optional[str] = None):
    """The scan outputs of this rank's L-shard of the full sequence: u,
    delta, B, C, z are the shards (batch, L_shard, ·) of rank
    `dist.get_rank(group)`; delta is the full (batch, L_shard, dim) delta
    in u's dtype.  `impl` as `selective_scan_state`."""
    kw = dict(D=D, z=z, delta_bias=delta_bias,
              delta_softplus=delta_softplus, impl=impl)
    _, h_last = selective_scan_state(u, delta, A, B, C,
                                     return_last_state=True, **kw)
    dt = delta.float()
    if delta_bias is not None:
        dt = dt + delta_bias.float()
    if delta_softplus:
        dt = softplus(dt)
    a_prod = torch.exp(dt.sum(1)[..., None] * A.float())
    parts = all_gather(torch.stack([a_prod, h_last]), group)
    h0 = torch.zeros_like(h_last)
    for a_j, h_j in parts[:dist.get_rank(group)]:
        h0 = a_j * h0 + h_j
    return selective_scan_state(u, delta, A, B, C, h0=h0, **kw)
