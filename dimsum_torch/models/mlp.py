"""Feed-forwards, port of `dimsum_tpu/models/mlp.py`: the gated `GatedMLP`
(GLU), the plain two-layer `Mlp` (`use_gated_mlp=False`) and the MoE
expert `ExpertMLP`.

`GatedMLP(..., tp_group=g)` is tensor-parallel by the JAX rules
(`parallel/mesh.py::TP_RULES`): w12 column-parallel, cut half by half so
that a rank holds the same hidden units of x1 and x2; w3 row-parallel, its
partial products summed over the group (`tp_sum`) and its bias, held whole,
added once after the sum.  `Mlp` has no rule in JAX and stays whole."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dimsum_torch.models.linear import Linear
from dimsum_torch.parallel.mesh import tp_copy, tp_size, tp_sum


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


class GatedMLP(nn.Module):
    """w3(gelu_tanh(x1) * x2) with w12 producing [x1; x2]."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, tp_group=None):
        super().__init__()
        k = tp_size(tp_group)
        if hidden_features % k:
            raise ValueError(f"hidden {hidden_features} does not split over "
                             f"{k} tensor-parallel ranks")
        self.tp_group = tp_group
        self.w12 = Linear(in_features, 2 * hidden_features // k, dtype=dtype)
        self.w3 = Linear(hidden_features // k, out_features or in_features,
                         dtype=dtype)

    def forward(self, x):
        x1, x2 = self.w12(tp_copy(x, self.tp_group)).chunk(2, dim=-1)
        h = gelu_tanh(x1) * x2
        if self.tp_group is None:
            return self.w3(h)
        dt = self.w3.compute_dtype
        out = tp_sum(F.linear(h.to(dt), self.w3.weight.to(dt)),
                     self.tp_group)
        return out + self.w3.bias.to(dt)


class Mlp(nn.Module):
    """fc2(gelu_tanh(fc1(x))), timm's two-layer MLP (the JAX `Mlp`,
    mlp.py:39-56)."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features, dtype=dtype)
        self.fc2 = Linear(hidden_features, out_features or in_features,
                          dtype=dtype)

    def forward(self, x):
        return self.fc2(gelu_tanh(self.fc1(x)))


class ExpertMLP(nn.Module):
    """An MoE expert's FFN (the JAX `ExpertMLP`, mlp.py:58-79):
    linear_fc1 -> GLU (gelu(a) * b) or GELU -> linear_fc2, hidden 4 * dim.
    Its GELU is the exact erf form, not the tanh form of the other MLPs."""

    def __init__(self, dim: int, add_bias_linear: bool = False,
                 gated_linear_unit: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = 4 * dim
        self.gated_linear_unit = gated_linear_unit
        self.linear_fc1 = Linear(dim, 2 * hidden if gated_linear_unit
                                 else hidden, bias=add_bias_linear,
                                 dtype=dtype)
        self.linear_fc2 = Linear(hidden, dim, bias=add_bias_linear,
                                 dtype=dtype)

    def forward(self, x):
        h = self.linear_fc1(x)
        if self.gated_linear_unit:
            a, b = h.chunk(2, dim=-1)
            h = F.gelu(a) * b
        else:
            h = F.gelu(h)
        return self.linear_fc2(h)
