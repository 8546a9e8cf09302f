"""Feed-forwards, port of `dimsum_tpu/models/mlp.py`: the gated `GatedMLP`
(GLU), the plain two-layer `Mlp` (`use_gated_mlp=False`) and the MoE
expert `ExpertMLP`."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dimsum_torch.models.linear import Linear


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


class GatedMLP(nn.Module):
    """w3(gelu_tanh(x1) * x2) with w12 producing [x1; x2]."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.w12 = Linear(in_features, 2 * hidden_features, dtype=dtype)
        self.w3 = Linear(hidden_features, out_features or in_features,
                         dtype=dtype)

    def forward(self, x):
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(gelu_tanh(x1) * x2)


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
