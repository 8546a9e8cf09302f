"""JAX params tree -> the port's torch state dict.

The inverse of `dimsum_tpu/utils/ckpt.py` (`_flax_path_for` and
`convert_torch_state_dict`, ckpt.py:32-153).  Layout maps undone here:

  * Dense kernel (in, out)             -> Linear weight (out, in)      [T]
  * conv1d_kernel (D, W)               -> Conv1d depthwise (D, 1, W)
  * x_embedder proj kernel (C*p*p, D)  -> Conv2d weight (D, C, p, p)
  * Embed embedding                    -> Embedding weight
  * AdaLN "…modulation/fc"             -> Sequential "…modulation.1"
  * final_layer adaLN_modulation_fc    -> final_layer.adaLN_modulation.1
  * t_embedder mlp_0 / mlp_2           -> t_embedder.mlp.0 / .2
  * mixer *_kernel / *_bias            -> dt_proj / conv1d .weight / .bias
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

_INDEXED = ("blocks", "local_experts", "attn_block", "fourier_blocks")


def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> Iterator:
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, np.asarray(tree)


def _module_name(parts) -> str:
    name = ".".join(parts)
    for stem in _INDEXED:
        name = re.sub(rf"\b{stem}_(\d+)\b", rf"{stem}.\1", name)
    name = re.sub(r"\bt_embedder\.mlp_([02])\b", r"t_embedder.mlp.\1", name)
    name = re.sub(r"\badaLN_modulation(?:\.|_)fc\b", "adaLN_modulation.1",
                  name)
    return name


def _torch_entry(path: Tuple[str, ...], arr: np.ndarray, in_channels: int):
    """(torch name, array in torch layout) for one flax leaf."""
    if path == ("pos_embed",):
        return "pos_embed", arr
    *stem, last = path
    m = re.fullmatch(r"(conv1d(?:_b)?|dt_proj(?:_b)?)_(kernel|bias)", last)
    if m and "mixer" in stem:
        mod, kind = m.groups()
        name = f"{_module_name(stem)}.{mod}."
        if kind == "bias":
            return name + "bias", arr
        if mod.startswith("conv1d"):
            return name + "weight", arr[:, None, :]
        return name + "weight", arr.T
    if last == "kernel":
        if stem[-2:] == ["x_embedder", "proj"]:
            k, d = arr.shape
            p = math.isqrt(k // in_channels)
            return (f"{_module_name(stem)}.weight",
                    arr.T.reshape(d, in_channels, p, p))
        return f"{_module_name(stem)}.weight", arr.T
    if last == "embedding":
        return f"{_module_name(stem)}.weight", arr
    return _module_name(path), arr


def state_dict_from_jax_params(params: Dict, in_channels: int = 4
                               ) -> Dict[str, torch.Tensor]:
    """Convert a flax params tree (nested dicts of arrays, with or without
    the top-level "params" collection) to the port's state dict of CPU
    tensors.  `in_channels` recovers the PatchEmbed conv shape."""
    if set(params.keys()) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(params):
        name, value = _torch_entry(path, arr, in_channels)
        if name in out:
            raise ValueError(f"two flax leaves map to {name!r}")
        out[name] = torch.from_numpy(np.ascontiguousarray(value).copy())
    return out
