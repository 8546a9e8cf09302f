"""Linear layer with a compute dtype (flax `nn.Dense(dtype=...)` semantics).

The JAX package keeps fp32 parameters and casts input, kernel and bias to
the module's dtype at each call.  `Linear` does the same, so a bf16 model
holds fp32 weights that load from any state dict; `cast_weights_` converts
them once to the compute dtype, which changes no result and saves the
per-call cast.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Linear(nn.Linear):
    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def cast_weights_(model: nn.Module) -> nn.Module:
    """Store every `Linear`'s parameters in its compute dtype (in place)."""
    for m in model.modules():
        if isinstance(m, Linear):
            m.to(m.compute_dtype)
    return model
