"""Checkpoints of the port, from `dimsum_tpu/utils/ckpt.py`:

  * `load_torch_checkpoint`: a reference `.pt` (published DiMSUM weights
    under "ema", the raw weights under "model") into the port's `DiM` or
    `DiT`.  The port's modules carry the reference's key names and layouts
    (the DiT's timm names `attn.qkv`, `attn.proj`, `mlp.fc1`, `mlp.fc2`;
    the MoE blocks' `mixer.router`, `mixer.local_experts.<e>.linear_fc1`
    and `linear_fc2`; the names `dimsum_tpu/utils/ckpt.py:36-51` maps to
    flax), so the state dict loads as it is; the load is strict by
    default.
  * `adapt_checkpoint`: the warm start across resolutions (256 -> 512 px):
    the position embedding resized bicubically as `jax.image.resize` does,
    the patch-embed and final-layer weights padded or sliced.
  * `save_train_state` / `load_train_state`: the port's `TrainState` as one
    `.pt` in the reference's layout ("model", "ema", "opt", and the step).
    The JAX package saves orbax directories instead; those are its own
    format, and the port does not read them.
  * `save_checkpoint` / `restore_checkpoint`: numbered snapshots of a
    `TrainState` in a directory (`<step:07d>.pt`, the reference's names),
    rotated to the newest `keep`, and the latest restored (the JAX
    functions of the same names, :226-252, over orbax).  Rank 0 writes;
    every rank reads.
  * With a tensor-parallel state (`tp_group`), a snapshot holds the full,
    unsharded state (`gather_train_state`: the model, the EMA and the
    AdamW moments gathered over the group, in the unsharded model's
    parameter order), so it loads at any --tp and into the JAX package;
    `shard_train_state` cuts it back to a rank's shards.

Checkpoints are read from a local path only.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

# frozen buffers of the reference's torch modules (wavelet and DCT filters,
# zigzag orders, rotary tables): the port regenerates them, as the JAX
# converter does (`convert_torch_state_dict`'s skip list)
FROZEN_BUFFERS = ("zigzag_paths", "zigzag_paths_reverse", "emb_sin",
                  "emb_cos", "dwt.", "idwt.", "dct_conv", "idct_conv",
                  "filters", "w_ll", "w_lh", "w_hl", "w_hh")


def _refuse_directory(path: str) -> None:
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: orbax checkpoint directories are the "
            "JAX package's format, which the port does not read; give a "
            "torch .pt file")


def check_state_dict(state_dict: Mapping[str, torch.Tensor],
                     template: Mapping[str, torch.Tensor]) -> None:
    """Raise if `state_dict` has a key `template` lacks, lacks one it has,
    or holds a tensor of another shape, listing each kind as the JAX
    converter does."""
    missing = sorted(set(template) - set(state_dict))
    unexpected = sorted(set(state_dict) - set(template))
    mismatched = sorted(k for k in set(template) & set(state_dict)
                        if tuple(template[k].shape)
                        != tuple(state_dict[k].shape))
    if missing or unexpected or mismatched:
        raise ValueError(
            "checkpoint mismatch:\n"
            f"  missing: {missing[:8]}{'...' if len(missing) > 8 else ''}\n"
            f"  unexpected: {unexpected[:8]}"
            f"{'...' if len(unexpected) > 8 else ''}\n"
            "  shape-mismatch: "
            f"{[(k, tuple(template[k].shape), tuple(state_dict[k].shape)) for k in mismatched[:8]]}")


def load_torch_checkpoint(path: str, model: nn.Module, key: str = "ema",
                          strict: bool = True, adapt: bool = False
                          ) -> nn.Module:
    """Load the weights under `key` ("ema" or "model") of a reference `.pt`
    into `model`, in place, and return it.  `strict` raises on a missing,
    unexpected or mis-shaped key (listing them); otherwise only the
    tensors whose names and shapes match are loaded.  `adapt` first fits
    the checkpoint to the model's shapes (`adapt_checkpoint`).  A file
    without `key` is read as the state dict itself, as the JAX loader
    reads it; the reference's frozen buffers are left out."""
    _refuse_directory(path)
    # the reference's files pickle their argparse namespace beside the
    # weights, so they need the full unpickler (a local file the user gave)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and key in ckpt:
        ckpt = ckpt[key]
    sd = {k: v.float() for k, v in ckpt.items()
          if isinstance(v, torch.Tensor)
          and not any(b in k for b in FROZEN_BUFFERS)}
    own = model.state_dict()
    if adapt:
        sd = adapt_checkpoint(sd, own)
    if strict:
        check_state_dict(sd, own)
    else:
        sd = {k: v for k, v in sd.items()
              if k in own and own[k].shape == v.shape}
    model.load_state_dict(sd, strict=strict)
    return model


# ---------------------------------------------------------------------------
# 256 -> 512 warm start
# ---------------------------------------------------------------------------


def _keys_cubic(x):
    """Keys' cubic convolution kernel with a = -0.5, for x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def resize_weights(in_size: int, out_size: int) -> torch.Tensor:
    """(in_size, out_size) fp32 weights of `jax.image.resize(...,
    "bicubic")` along one axis (`scale_and_translate` with translation 0
    and antialiasing): half-pixel centres, the kernel widened by the
    scale when downsizing, taps outside the input dropped and the rest
    renormalized, samples outside the input zeroed.  This is not
    `F.interpolate(mode="bicubic")`, which uses a = -0.75 and clamps
    indices at the edges."""
    f32 = torch.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = ((torch.arange(out_size, dtype=f32) + 0.5) * inv_scale - 0.5)
    x = torch.abs(sample_f[None, :] - torch.arange(in_size, dtype=f32)[:, None]
                  ) / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * torch.finfo(f32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_pos_embed(pos_embed: torch.Tensor, num_tokens: int) -> torch.Tensor:
    """(1, L, D) -> (1, num_tokens, D): the square token grid resized
    bicubically as the JAX `adapt_checkpoint` does."""
    _, n_old, d = pos_embed.shape
    old, new = round(n_old ** 0.5), round(num_tokens ** 0.5)
    grid = pos_embed.float().reshape(1, old, old, d)
    w = resize_weights(old, new)
    out = torch.einsum("bhwd,hi,wj->bijd", grid, w, w)
    return out.reshape(1, new * new, d)


def _pad_or_slice(arr: torch.Tensor, shape) -> torch.Tensor:
    """Zero-pad each axis at its end up to `shape`, then slice to it."""
    pad = []
    for want, have in zip(reversed(shape), reversed(arr.shape)):
        pad += [0, max(0, want - have)]
    arr = torch.nn.functional.pad(arr, pad)
    return arr[tuple(slice(0, w) for w in shape)]


def adapt_checkpoint(state_dict: Mapping[str, torch.Tensor],
                     template: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Fit a state dict to `template`'s shapes (a model's state dict) for a
    warm start across resolutions or patch sizes, as the JAX
    `adapt_checkpoint` does:

      * pos_embed: the token grid resized bicubically (`resize_pos_embed`);
      * the patch-embed weights and the final layer's linear: zero-padded
        or sliced, in the JAX package's layouts (the patch-embed conv
        weight flattened to (D, C p p), the rest as they are).
    Tensors of the template's shape, and names the template lacks, pass
    through; any other mismatch raises."""
    out = {}
    for name, arr in state_dict.items():
        want = template.get(name)
        if want is None or tuple(want.shape) == tuple(arr.shape):
            out[name] = arr
        elif "pos_embed" in name:
            out[name] = resize_pos_embed(arr, want.shape[1])
        elif arr.ndim == 4 and "x_embedder" in name:
            flat = _pad_or_slice(arr.reshape(arr.shape[0], -1),
                                 (want.shape[0], want[0].numel()))
            out[name] = flat.reshape(want.shape)
        elif "x_embedder" in name or ("final_layer" in name
                                      and "linear" in name):
            out[name] = _pad_or_slice(arr, tuple(want.shape))
        else:
            raise ValueError(f"cannot adapt {name}: {tuple(arr.shape)} -> "
                             f"{tuple(want.shape)}")
    return out


# ---------------------------------------------------------------------------
# the port's TrainState
# ---------------------------------------------------------------------------


def unsharded_meta(model: nn.Module) -> nn.Module:
    """A tensor-parallel model's unsharded twin on the meta device (its
    names, order and shapes; no memory)."""
    import dataclasses

    with torch.device("meta"):
        return type(model)(dataclasses.replace(model.cfg, tp_group=None))


def full_names(model: nn.Module):
    """The unsharded model's parameter names and state-dict keys, in its
    order."""
    full = unsharded_meta(model)
    return [n for n, _ in full.named_parameters()], list(full.state_dict())


def gather_train_state(state, tp_group) -> dict:
    """The full payload of a tensor-parallel `TrainState` ("model", "ema",
    "opt" in the unsharded model's order, "step"), on every rank of the
    model group (a collective: every rank calls it)."""
    from dimsum_torch.parallel.mesh import gather_state_dict

    names, keys = full_names(state.model)
    model_full = gather_state_dict(state.model.state_dict(), tp_group,
                                   order=keys)
    ema = gather_state_dict(state.ema_params, tp_group, order=names)
    opt = state.optimizer.state_dict()
    local = [n for n, _ in state.model.named_parameters()]
    moments = {}
    for key in ("exp_avg", "exp_avg_sq"):
        per_name = {n: opt["state"][i][key] for i, n in enumerate(local)
                    if i in opt["state"]}
        if per_name:
            moments[key] = gather_state_dict(per_name, tp_group, order=names)
    full_state = {}
    if moments:
        step = next(iter(opt["state"].values()))["step"]
        full_state = {i: {"step": step.clone(),
                          "exp_avg": moments["exp_avg"][n],
                          "exp_avg_sq": moments["exp_avg_sq"][n]}
                      for i, n in enumerate(names)}
    groups = [dict(g, params=list(range(len(names))))
              for g in opt["param_groups"]]
    return {"model": model_full, "ema": ema,
            "opt": {"state": full_state, "param_groups": groups},
            "step": state.step}


def shard_train_state(payload: Mapping, state, tp_group) -> None:
    """Load a full payload (`gather_train_state`'s, or an unsharded run's
    snapshot) into a tensor-parallel `state`, in place: each rank keeps
    its shards."""
    from dimsum_torch.parallel.mesh import (shard_state_dict, tp_rank,
                                            tp_size)

    r, k = tp_rank(tp_group), tp_size(tp_group)
    names, _ = full_names(state.model)
    model_sd = shard_state_dict(payload["model"], r, k)
    check_state_dict(model_sd, state.model.state_dict())
    state.model.load_state_dict(model_sd, strict=True)
    ema = shard_state_dict(payload["ema"], r, k)
    check_state_dict(ema, state.ema_params)
    with torch.no_grad():
        for name, e in state.ema_params.items():
            e.copy_(ema[name])
    opt = payload["opt"]
    local = [n for n, _ in state.model.named_parameters()]
    per_key = {}
    for key in ("exp_avg", "exp_avg_sq"):
        full = {n: opt["state"][i][key] for i, n in enumerate(names)
                if i in opt["state"]}
        per_key[key] = shard_state_dict(full, r, k) if full else {}
    new_state = {}
    if per_key["exp_avg"]:
        step = next(iter(opt["state"].values()))["step"]
        new_state = {i: {"step": step.clone(),
                         "exp_avg": per_key["exp_avg"][n],
                         "exp_avg_sq": per_key["exp_avg_sq"][n]}
                     for i, n in enumerate(local)}
    groups = [dict(g, params=list(range(len(local))))
              for g in opt["param_groups"]]
    state.optimizer.load_state_dict({"state": new_state,
                                     "param_groups": groups})
    state.step = int(payload["step"])


def save_train_state(path: str, state, args=None, payload=None) -> None:
    """Save a `parallel.TrainState` as one `.pt` in the reference's layout:
    "model" (the fp32 master weights), "ema", "opt" (the optimizer's state
    dict), "step", and `args` (the reference stores its argparse
    namespace there).  `payload` (a tensor-parallel state's gathered one)
    replaces the state's own tensors."""
    _refuse_directory(path)
    if payload is None:
        payload = {"model": state.model.state_dict(),
                   "ema": dict(state.ema_params),
                   "opt": state.optimizer.state_dict(),
                   "step": state.step}
    torch.save({**payload, "args": args}, path)


def load_train_state(path: str, state, tp_group=None):
    """Resume `state` (a `parallel.TrainState` built for the same model and
    optimizer) from `save_train_state`'s file, in place: the weights
    strictly, the EMA copy, the optimizer's moments and step counts, and
    the step (with `tp_group`, each rank's shards of them).  Returns the
    state."""
    _refuse_directory(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if tp_group is not None:
        shard_train_state(ckpt, state, tp_group)
        return state
    own = state.model.state_dict()
    check_state_dict(ckpt["model"], own)
    state.model.load_state_dict(ckpt["model"], strict=True)
    check_state_dict(ckpt["ema"], state.ema_params)
    with torch.no_grad():
        for name, e in state.ema_params.items():
            e.copy_(ckpt["ema"][name])
    state.optimizer.load_state_dict(ckpt["opt"])
    state.step = int(ckpt["step"])
    return state


# ---------------------------------------------------------------------------
# numbered snapshots in a directory
# ---------------------------------------------------------------------------

_SNAPSHOT = re.compile(r"^(\d+)\.pt$")


def checkpoint_steps(ckpt_dir: str) -> List[int]:
    """The steps of the snapshots in `ckpt_dir`, oldest first."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_SNAPSHOT.match,
                                               os.listdir(ckpt_dir)) if m)


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def save_checkpoint(ckpt_dir: str, state, step: int, keep: int = 5,
                    args=None, tp_group=None) -> None:
    """Write `state` as `<ckpt_dir>/<step:07d>.pt` (`save_train_state`'s
    layout; written to a temporary name and renamed, so a snapshot is
    whole or absent), then delete all but the `keep` newest snapshots.  In
    a multi-process run only rank 0 writes (the state is the same on every
    rank; with `tp_group` the model group first gathers it), and every
    rank returns after the write."""
    payload = (gather_train_state(state, tp_group)
               if tp_group is not None else None)
    if _rank() == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        path = os.path.join(ckpt_dir, f"{step:07d}.pt")
        tmp = f"{path}.tmp"
        save_train_state(tmp, state, args, payload)
        os.replace(tmp, path)
        for old in checkpoint_steps(ckpt_dir)[:-keep]:
            os.remove(os.path.join(ckpt_dir, f"{old:07d}.pt"))
    if dist.is_initialized():
        dist.barrier()


def restore_checkpoint(ckpt_dir: str, state, step: Optional[int] = None,
                       tp_group=None):
    """Resume `state` in place from the snapshot at `step` in `ckpt_dir`
    (None: the latest; with `tp_group`, each rank's shards).  Returns
    (state, step), or (None, None) when the directory holds no
    snapshot."""
    steps = checkpoint_steps(ckpt_dir)
    if step is None:
        if not steps:
            return None, None
        step = steps[-1]
    load_train_state(os.path.join(ckpt_dir, f"{step:07d}.pt"), state,
                     tp_group)
    return state, step
