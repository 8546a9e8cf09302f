"""JAX params trees -> the port's torch state dicts: the DiM
(`state_dict_from_jax_params`), the Mamba LM
(`lm_state_dict_from_jax_params`) and the FID InceptionV3
(`inception_state_dict_from_flax`).

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
                                          (v2's dt_proj_b / conv1d_b too)
  * blocks_i, attn_block_i, fourier_blocks_i, local_experts_e
                                       -> blocks.i, attn_block.i, ...
  * pos_cnn proj kernel (3, 3, 1, D)   -> pos_cnn.proj.0 Conv2d (D, 1, 3, 3)
  * pos_cnn norm_scale / norm_bias     -> pos_cnn.norm.weight / .bias

Every other leaf keeps its name and layout: v2's A_b_log and D_b, EinFFT's
complex_weight_* / complex_bias_*, the LayerNorm biases, norm_f, the
plain MLP's fc1 / fc2, a DiT's blocks, the MoE router and experts'
linear_fc1 / linear_fc2, and CondMamba's cond_proj (Dense kernels,
transposed as any other).
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

_INDEXED = ("blocks", "local_experts", "attn_block", "fourier_blocks")
_POS_CNN_NORM = {"norm_scale": "pos_cnn.norm.weight",
                 "norm_bias": "pos_cnn.norm.bias"}


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
    if stem == ["pos_cnn", "proj"]:  # flax (kh, kw, 1, D) depthwise conv
        if last == "kernel":
            return "pos_cnn.proj.0.weight", arr.transpose(3, 2, 0, 1)
        return "pos_cnn.proj.0.bias", arr
    if stem == ["pos_cnn"] and last in _POS_CNN_NORM:
        return _POS_CNN_NORM[last], arr
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
    tensors.  `in_channels` recovers the PatchEmbed conv shape.  A gradient
    tree (`jax.grad` of a function of the params) has the params' structure
    and converts the same way, to gradients under the port's names."""
    if set(params.keys()) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(params):
        name, value = _torch_entry(path, arr, in_channels)
        if name in out:
            raise ValueError(f"two flax leaves map to {name!r}")
        out[name] = torch.from_numpy(np.ascontiguousarray(value).copy())
    return out


def lm_state_dict_from_jax_params(params: Dict) -> Dict[str, torch.Tensor]:
    """The JAX `MambaLMHeadModel`'s params tree (with or without the
    top-level "params") -> the port's LM state dict, which carries the HF
    checkpoint names: embedding/embedding -> backbone.embedding.weight (and
    lm_head.weight, tied, unless the tree has its own lm_head kernel),
    layers_N/norm_weight (norm_bias) -> backbone.layers.N.norm.weight
    (.bias), layers_N/mixer/... -> backbone.layers.N.mixer.... (the DiM
    mixer's layout maps), norm_f_weight -> backbone.norm_f.weight."""
    if set(params.keys()) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(params):
        head, *rest = path
        if path == ("embedding", "embedding"):
            name, value = "backbone.embedding.weight", arr
        elif path == ("norm_f_weight",):
            name, value = "backbone.norm_f.weight", arr
        elif path == ("lm_head", "kernel"):
            name, value = "lm_head.weight", arr.T
        elif re.fullmatch(r"layers_\d+", head):
            stem = f"backbone.layers.{head.split('_')[1]}."
            if rest in (["norm_weight"], ["norm_bias"]):
                name = stem + "norm." + rest[0].split("_")[1]
                value = arr
            else:
                name, value = _torch_entry(tuple(rest), arr, in_channels=0)
                name = stem + name
        else:
            raise ValueError(f"unexpected LM param {'/'.join(path)}")
        out[name] = torch.from_numpy(np.ascontiguousarray(value).copy())
    out.setdefault("lm_head.weight", out["backbone.embedding.weight"])
    return out


_BN_LEAVES = {"bn_weight": "bn.weight", "bn_bias": "bn.bias",
              "bn_mean": "bn.running_mean", "bn_var": "bn.running_var"}


def inception_state_dict_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """A flax InceptionV3 params tree (`dimsum_tpu/eval/inception.py`,
    numpy leaves) -> the port's `InceptionV3Features` state dict under
    torchvision's names, the inverse of the JAX
    `convert_inception_state_dict` (:224-251): conv kernel (kh, kw, I, O)
    -> weight (O, I, kh, kw); bn_{weight,bias,mean,var} ->
    bn.{weight,bias,running_mean,running_var}; num_batches_tracked 0."""
    if set(params.keys()) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(params):
        *stem, last = path
        if last == "kernel" and stem[-1] == "conv":
            name, value = ".".join(stem) + ".weight", arr.transpose(3, 2, 0, 1)
        elif last in _BN_LEAVES:
            name, value = ".".join(stem + [_BN_LEAVES[last]]), arr
            out[".".join(stem + ["bn.num_batches_tracked"])] = torch.tensor(
                0, dtype=torch.long)
        else:
            raise ValueError(f"unexpected InceptionV3 leaf {'/'.join(path)}")
        out[name] = torch.from_numpy(np.ascontiguousarray(value).copy())
    return out
