"""Gated feed-forward (GLU), port of `dimsum_tpu/models/mlp.py::GatedMLP`."""

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
