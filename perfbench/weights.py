"""Seeded weights of a configuration, made on the device in a few large
calls: the inputs the benchmark hands to the port and to the reference
alike.

The names and shapes are the reference model's (`reference.model.build`),
which are the port's state-dict names.  The values follow the port's
seeded init for runs without a checkpoint (`dimsum_torch/models/dim.py::
random_init_` at 47e520a), so that the network is in the regime it is
tested in, with two differences that make every operand carry data: the
biases are drawn like their weights, not zero, and the adaLN and final
layers are drawn, not zero (as the port's init also draws them).

    weight                      U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    bias                        as its module's weight
    norm weight                 1
    pos_embed                   the 2-D sin-cos table
    A_log                       log(1 .. N) on every channel
    D                           1
    dt_proj.bias                softplus^-1(dt), dt log-uniform in [1e-3, 0.1]
    label table                 N(0, 0.02^2)

All uniform draws come from one `torch.rand` and all normal ones from one
`torch.randn` of a generator on the device seeded from `seed`; the same
seed gives the same weights on the same device.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from perfbench.reference.model import sincos_pos_embed


def _rule(name: str, shape) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if name == "pos_embed":
        return "sincos"
    if leaf == "A_log":
        return "a_log"
    if leaf == "D":
        return "one"
    if name.endswith(("norm.weight", "norm_2.weight")):
        return "one"
    if name.endswith("dt_proj.bias"):
        return "dt_bias"
    if name.endswith("embedding_table.weight"):
        return "normal"
    return "uniform"


def _fan_in(name: str, shapes: Dict[str, torch.Size]) -> int:
    if name.endswith(".bias"):
        name = name[: -len("bias")] + "weight"
    shape = shapes[name]
    return int(math.prod(shape[1:]))


def make_weights(model: torch.nn.Module, seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on `device`} for every parameter of `model`
    (a reference model, on any device, meta included)."""
    shapes = {n: p.shape for n, p in model.named_parameters()}
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(int(seed) % (2 ** 63))
    rules = {n: _rule(n, s) for n, s in shapes.items()}
    uni = [n for n, r in rules.items() if r in ("uniform", "dt_bias")]
    nor = [n for n, r in rules.items() if r == "normal"]
    n_uni = sum(math.prod(shapes[n]) for n in uni)
    n_nor = sum(math.prod(shapes[n]) for n in nor)
    u = torch.rand(n_uni, generator=g, device=dev)
    z = torch.randn(n_nor, generator=g, device=dev)
    # one scale a value: 2 bound for the uniform leaves (then shifted by
    # -bound), the dt leaves left in [0, 1)
    sizes = torch.tensor([math.prod(shapes[n]) for n in uni], device=dev)
    bound = torch.tensor([1.0 / math.sqrt(_fan_in(n, shapes))
                          if rules[n] == "uniform" else 0.0 for n in uni],
                         device=dev)
    b = torch.repeat_interleave(bound, sizes)
    is_u = torch.repeat_interleave((bound > 0).float(), sizes)
    u = u * (2 * b + (1 - is_u)) - b
    z = z * 0.02
    out, ou, oz = {}, 0, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        rule = rules[name]
        if rule in ("uniform", "dt_bias"):
            t = u[ou:ou + n].view(shape)
            ou += n
            if rule == "dt_bias":
                dt = torch.exp(t * (math.log(0.1) - math.log(1e-3))
                               + math.log(1e-3)).clamp_min(1e-4)
                t = dt + torch.log(-torch.expm1(-dt))
        elif rule == "normal":
            t = z[oz:oz + n].view(shape)
            oz += n
        elif rule == "one":
            t = torch.ones(shape, device=dev)
        elif rule == "a_log":
            t = torch.log(torch.arange(1, shape[1] + 1, device=dev,
                                       dtype=torch.float32)).expand(shape)
            t = t.contiguous()
        else:  # sincos
            t = torch.tensor(sincos_pos_embed(
                shape[-1], int(round(shape[1] ** 0.5)))).to(dev)[None]
        out[name] = t
    return out
