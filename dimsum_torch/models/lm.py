"""Mamba language model, port of `dimsum_tpu/models/lm.py`: the
MixerModel / MambaLMHeadModel stack of `state-spaces/mamba-*` and its
generation loop.

  * scoring forward: embedding -> n_layer x (add + norm -> Mamba mixer)
    -> add + final norm -> tied lm_head, the selective scan over the whole
    sequence (on the card the scan kernel, one launch a layer);
  * generation (`generate`): the prompt fed token by token, then decoding,
    each step one token through every layer with its (conv_state,
    ssm_state) carried (`mamba_step`: the plain one-token recurrences
    `causal_conv1d_update` and `selective_state_update`).  JAX runs the
    loop as one compiled program; here it is a Python loop of eager steps
    (CUDA graphs would be the tool to cut its launch overhead).

Parameter names are those of the reference's Hugging Face checkpoints
(`backbone.embedding.weight`, `backbone.layers.N.norm.weight`,
`backbone.layers.N.mixer.in_proj.weight`, ..., `backbone.norm_f.weight`,
`lm_head.weight` tied to the embedding), so a local `state-spaces/mamba-*`
state dict loads strictly (`dimsum_torch.utils.hf.load_hf_mamba`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dimsum_torch.models.blocks import Norm
from dimsum_torch.models.dim import random_init_
from dimsum_torch.models.linear import cast_weights_
from dimsum_torch.models.mamba import Mamba
from dimsum_torch.ops.causal_conv1d import causal_conv1d_update
from dimsum_torch.ops.norms import fused_add_norm
from dimsum_torch.ops.selective_scan import selective_state_update
from dimsum_torch.utils.device import resolve_device

__all__ = ["MambaLMConfig", "LMBlock", "MambaLMHeadModel", "build_lm",
           "cast_lm_weights_", "mamba_step", "generate", "MAMBA_LM_CONFIGS"]


@dataclasses.dataclass(frozen=True)
class MambaLMConfig:
    """The JAX `MambaLMConfig`, with the mixer's widths (fixed there)."""

    d_model: int = 768
    n_layer: int = 24
    vocab_size: int = 50277
    rms_norm: bool = True
    residual_in_fp32: bool = True
    pad_vocab_size_multiple: int = 8
    tie_embeddings: bool = True
    dtype: torch.dtype = torch.float32
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_size_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return math.ceil(self.d_model / 16)


# The published `state-spaces/mamba-*` configs (their config.json: d_model,
# n_layer; vocab 50277 padded to a multiple of 8, rms_norm,
# residual_in_fp32, tied embeddings, d_state 16, d_conv 4, expand 2)
MAMBA_LM_CONFIGS = {
    "mamba-130m": dict(d_model=768, n_layer=24),
    "mamba-370m": dict(d_model=1024, n_layer=48),
    "mamba-790m": dict(d_model=1536, n_layer=48),
    "mamba-1.4b": dict(d_model=2048, n_layer=48),
    "mamba-2.8b": dict(d_model=2560, n_layer=64),
}


class LMBlock(nn.Module):
    """Add -> Norm -> Mixer prenorm block (the JAX `LMBlock`): returns
    (mixer output, residual), the residual in fp32 with
    `residual_in_fp32`."""

    def __init__(self, cfg: MambaLMConfig, layer_idx: int = 0,
                 norm_eps: float = 1e-5):
        super().__init__()
        self.residual_in_fp32 = cfg.residual_in_fp32
        self.norm = Norm(cfg.d_model, eps=norm_eps, rms=cfg.rms_norm)
        self.mixer = Mamba(cfg.d_model, d_state=cfg.d_state,
                           d_conv=cfg.d_conv, expand=cfg.expand,
                           dtype=cfg.dtype, layer_idx=layer_idx)

    def forward(self, hidden_states, residual=None):
        n = self.norm
        hidden_states, residual = fused_add_norm(
            hidden_states, n.weight, n.bias, residual=residual, eps=n.eps,
            residual_in_fp32=self.residual_in_fp32, is_rms=n.rms,
            kernel=n.pallas_norm, impl=n.norm_impl)
        return self.mixer(hidden_states), residual


class MixerModel(nn.Module):
    """The reference's `backbone`: embedding, layers, final norm.  The
    final norm has a weight only, as in JAX (`norm_f_weight`), whichever
    norm the config names."""

    def __init__(self, cfg: MambaLMConfig):
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Embedding(cfg.padded_vocab, cfg.d_model)
        self.layers = nn.ModuleList(LMBlock(cfg, layer_idx=i)
                                    for i in range(cfg.n_layer))
        self.norm_f = Norm(cfg.d_model)

    def forward(self, input_ids):
        cfg = self.cfg
        x = self.embedding(input_ids).to(cfg.dtype)
        residual = None
        for layer in self.layers:
            x, residual = layer(x, residual)
        n = self.norm_f
        return fused_add_norm(x, n.weight, None, residual=residual,
                              eps=n.eps, prenorm=False, is_rms=cfg.rms_norm,
                              kernel=n.pallas_norm, impl=n.norm_impl)


class MambaLMHeadModel(nn.Module):
    """input_ids (B, L) int64 -> logits (B, L, padded_vocab) fp32, the JAX
    `MambaLMHeadModel.__call__`.  `lm_head.weight` is the embedding's
    (tied) unless `tie_embeddings` is False."""

    def __init__(self, cfg: MambaLMConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = MixerModel(cfg)
        self.lm_head = nn.Linear(cfg.d_model, cfg.padded_vocab, bias=False)
        if cfg.tie_embeddings:
            self.lm_head.weight = self.backbone.embedding.weight

    def forward(self, input_ids):
        x = self.backbone(input_ids)
        return self.logits(x)

    def logits(self, x):
        """The lm_head on final-norm outputs x (..., d_model), in x's
        dtype, returned in fp32."""
        return F.linear(x, self.lm_head.weight.to(x.dtype)).float()


def build_lm(cfg: MambaLMConfig, device="cuda", seed: int = 0
             ) -> MambaLMHeadModel:
    """A MambaLMHeadModel on `device` (CUDA unless the caller asks for the
    CPU) with seeded random weights, in eval mode: the DiM's
    `random_init_` rules (projections U(+-1/sqrt(fan_in)), the Mamba
    A_log, D and dt bias inits, norm weights 1) and the embedding
    N(0, 0.02^2), the JAX init; then `cast_lm_weights_`."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = MambaLMHeadModel(cfg)
    with torch.no_grad():
        random_init_(model, seed)
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        model.backbone.embedding.weight.normal_(0.0, 0.02, generator=g)
    return cast_lm_weights_(model).eval()


def cast_lm_weights_(model: MambaLMHeadModel) -> MambaLMHeadModel:
    """Store the Linear weights and the (tied) embedding in the config's
    dtype, in place: what the JAX model casts them to at each call, so no
    result changes."""
    cast_weights_(model)
    model.backbone.embedding.to(model.cfg.dtype)
    return model


# ---------------------------------------------------------------------------
# One-token decoding
# ---------------------------------------------------------------------------

def mamba_step(mixer: Mamba, x, conv_state, ssm_state):
    """One token through a Mamba mixer (the JAX `mamba_step`, reference
    mamba_simple.py:299-344), with the mixer's own parameters.

    x: (B, d_model); conv_state: (B, d_conv, d_inner), the last d_conv
    conv inputs; ssm_state: (B, d_inner, N) fp32.  Returns (out (B,
    d_model), conv_state, ssm_state), the states new tensors.  Takes
    scan_type "none" (one forward branch), the LM's mixer."""
    if mixer.scan_type != "none":
        raise NotImplementedError(
            f"mamba_step takes scan_type 'none'; got {mixer.scan_type!r}")
    xz = mixer.in_proj(x)
    xi, z = xz.chunk(2, dim=-1)
    xc, conv_state = causal_conv1d_update(
        xi, conv_state, mixer.conv1d.weight[:, 0, :], mixer.conv1d.bias,
        activation="silu")
    r, n = mixer.dt_rank, mixer.d_state
    dt_low, Bm, Cm = mixer.x_proj(xc).split([r, n, n], dim=-1)
    dt = dt_low @ mixer.dt_proj.weight.t().to(dt_low.dtype)
    A = -torch.exp(mixer.A_log.float())
    y, ssm_state = selective_state_update(
        ssm_state, xc, dt, A, Bm, Cm, D=mixer.D, z=z,
        dt_bias=mixer.dt_proj.bias, dt_softplus=True)
    return mixer.out_proj(y), conv_state, ssm_state


def _empty_states(model: MambaLMHeadModel, batch: int, device):
    """Each layer's zero (conv_state, ssm_state), both fp32 (as JAX)."""
    cfg = model.cfg
    return [(torch.zeros(batch, cfg.d_conv, cfg.d_inner, device=device),
             torch.zeros(batch, cfg.d_inner, cfg.d_state, device=device))
            for _ in range(cfg.n_layer)]


def _forward_token(model: MambaLMHeadModel, states, token):
    """One token (B,) through the whole model: (new states, logits (B, V)
    fp32).  As the JAX `generate`'s `forward_token`: the residual stream in
    the activations' dtype and each norm in fp32."""
    cfg = model.cfg
    bb = model.backbone
    x = bb.embedding(token).to(cfg.dtype)
    residual = None
    new_states = []
    for layer, (cs, ss) in zip(bb.layers, states):
        total = x if residual is None else x + residual
        n = layer.norm
        normed = fused_add_norm(total, n.weight, n.bias, eps=n.eps,
                                prenorm=False, is_rms=n.rms)
        out, cs, ss = mamba_step(layer.mixer, normed, cs, ss)
        new_states.append((cs, ss))
        x, residual = out, total
    final = fused_add_norm(x + residual, bb.norm_f.weight, None,
                           eps=bb.norm_f.eps, prenorm=False,
                           is_rms=cfg.rms_norm)
    return new_states, model.logits(final)


def _sample_token(logits, temperature: float, top_k: int,
                  generator: Optional[torch.Generator]):
    """Greedy at temperature 0; otherwise a draw from softmax(logits /
    temperature), restricted to the top_k largest when top_k > 0."""
    if temperature == 0.0:
        return logits.argmax(-1)
    logits = logits / temperature
    if top_k > 0:
        kth = logits.sort(-1).values[:, -top_k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    probs = torch.softmax(logits.float(), -1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(model: MambaLMHeadModel, input_ids, max_new_tokens: int,
             generator: Optional[torch.Generator] = None,
             temperature: float = 1.0, top_k: int = 0):
    """Autoregressive generation, the JAX `generate`: the prompt fed token
    by token (the prefill), then max_new_tokens tokens sampled, each fed
    back.  input_ids: (B, L_prompt) int64 on the model's device.  Returns
    (B, L_prompt + max_new_tokens).  Sampling draws from `generator` (on
    the model's device; None: the default one); temperature 0 is greedy,
    as in JAX, and needs no generator."""
    B, L = input_ids.shape
    if L < 1 or max_new_tokens < 1:
        raise ValueError("generate needs a prompt and max_new_tokens >= 1")
    states = _empty_states(model, B, input_ids.device)
    for t in range(L):
        states, logits = _forward_token(model, states, input_ids[:, t])
    new: List[torch.Tensor] = []
    for i in range(max_new_tokens):
        token = _sample_token(logits, temperature, top_k, generator)
        new.append(token)
        if i + 1 < max_new_tokens:
            states, logits = _forward_token(model, states, token)
    return torch.cat([input_ids, torch.stack(new, dim=1)], dim=1)

