"""Local Hugging Face Mamba LM checkpoints, port of `dimsum_tpu/utils/hf.py`.

A `state-spaces/mamba-*` checkpoint (`pytorch_model.bin`, or
`model.safetensors` where the `safetensors` package is installed) is read
from a local path; nothing is downloaded.  Its names are the port's
(`dimsum_torch/models/lm.py`), so the state dict loads strictly as it is:

  backbone.embedding.weight               (vocab, d_model)
  backbone.layers.N.norm.weight           (d_model,)
  backbone.layers.N.mixer.in_proj.weight  ... out_proj.weight, A_log, D
  backbone.norm_f.weight                  (d_model,)
  lm_head.weight                          tied: equal to the embedding

n_layer, d_model and the vocab size are read from the shapes, as in JAX
(the file's vocab is already padded: the config pads to a multiple of 1).
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import torch

from dimsum_torch.models.lm import (MambaLMConfig, MambaLMHeadModel,
                                    cast_lm_weights_)
from dimsum_torch.utils.device import resolve_device

__all__ = ["load_hf_mamba"]


def _read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a local `.bin` / `.pt` (torch.load) or
    `.safetensors` file, on the CPU in fp32."""
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(
                f"{path}: reading .safetensors needs the safetensors "
                "package; convert the checkpoint to a .bin state dict "
                "(torch.save) instead") from e
        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float() for k, v in sd.items()}


def _lm_config(sd: Dict[str, torch.Tensor], dtype) -> MambaLMConfig:
    """The MambaLMConfig of an HF Mamba state dict: n_layer from the layer
    indices, d_model and the (padded) vocab from the embedding.  Raises if
    `lm_head.weight` is present and differs from the embedding (an untied
    head, which the LM does not build)."""
    emb = sd["backbone.embedding.weight"]
    head = sd.get("lm_head.weight")
    if head is not None and not torch.equal(head, emb):
        raise ValueError("lm_head.weight differs from "
                         "backbone.embedding.weight: the Mamba LM ties them")
    layers = [int(m.group(1)) for k in sd
              if (m := re.match(r"backbone\.layers\.(\d+)\.", k))]
    if not layers:
        raise ValueError("no backbone.layers.N.* keys in the state dict")
    return MambaLMConfig(d_model=emb.shape[1], n_layer=1 + max(layers),
                         vocab_size=emb.shape[0], pad_vocab_size_multiple=1,
                         dtype=dtype)


def load_hf_mamba(path: str, device="cuda", dtype=torch.float32
                  ) -> Tuple[MambaLMConfig, MambaLMHeadModel]:
    """(config, model) of a local HF Mamba checkpoint: the model on
    `device` (the card unless the caller asks for the CPU), the state dict
    loaded strictly (`lm_head.weight` added from the embedding where the
    file leaves it out), weights stored in `dtype` (`cast_lm_weights_`),
    in eval mode."""
    sd = _read_state_dict(path)
    cfg = _lm_config(sd, dtype)
    sd.setdefault("lm_head.weight", sd["backbone.embedding.weight"])
    dev = resolve_device(device)
    with torch.device("meta"):
        model = MambaLMHeadModel(cfg)
    model.load_state_dict(sd, strict=True, assign=True)
    model.lm_head.weight = model.backbone.embedding.weight
    return cfg, cast_lm_weights_(model.to(dev)).eval()
