"""Flow-matching train step, port of `dimsum_tpu/parallel/train.py`
(:23-181): AdamW, global-norm clipping, EMA, gradient accumulation, data
parallelism over a `torch.distributed` process group, and the optional
warmup + cosine learning-rate schedule.

    state = create_train_state(model, create_optimizer(model))
    step = make_train_step(model, transport, state.optimizer)
    metrics = step(state, x, y, generator)

The model holds the fp32 master parameters (`build_dim(..., train=True)`);
the optimizer holds the AdamW moments; `TrainState.ema_params` the EMA
copy.  Parameters are updated in place, which the JAX step gets by donating
its state.  A parameter that takes no gradient in a step (CondMamba's
`cond_proj`, which stays out of the graph) gets a zero gradient before the
update, so that AdamW steps it as optax steps every parameter: its moments
decay, and weight decay shrinks it.  Checkpoints are
`dimsum_torch.utils.ckpt`; remat is a `DiMConfig` switch.

Data parallelism (`make_train_step(..., group=g)`) is the reference's DDP
(train.py:145-180) and the JAX step's `lax.pmean` (:164-166): every rank
holds the same parameters, steps its own slice of the global batch, and
the step averages the gradients and the loss over the group in one
flattened all-reduce before the clip, AdamW and EMA, which then run the
same on every rank.  Each rank draws from its own generator, seeded
`global_seed * world_size + rank`, as the reference seeds its ranks
(train.py:155); the caller creates it.

Tensor parallelism (`make_train_step(..., tp_group=g)`, the model built
with `DiMConfig.tp_group`; the JAX step under `tp_shardings`,
train.py:144-160): the model group's ranks take the same batch and the same
draws, each holds its shards of the sharded parameters, and the step is the
unsharded one: AdamW and the EMA act element by element on each shard, and
the global norm of the clip sums the shards' squares over the group
(`clip_by_global_norm(..., tp_group=g)`).  `group` is then the data group:
the gradients are averaged over the data ways only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from dimsum_torch.parallel.mesh import group_sum, is_sharded


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module  # its parameters are the fp32 master weights
    optimizer: torch.optim.Optimizer
    ema_params: Dict[str, torch.Tensor]


def create_optimizer(model: nn.Module, lr: float = 1e-4,
                     weight_decay: float = 0.0,
                     betas=(0.9, 0.999)) -> torch.optim.AdamW:
    """AdamW as the JAX `create_optimizer` sets it (optax.adamw: eps 1e-8,
    constant lr, wd 0 by default): lr (m/(1 - b1^k) / (sqrt(v/(1 - b2^k))
    + eps) + wd p), with every parameter stepped (`make_train_step` gives
    a parameter that took no gradient a zero one)."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=tuple(betas),
                             eps=1e-8, weight_decay=weight_decay)


def warmup_cosine_schedule(optimizer: torch.optim.Optimizer, lr: float,
                           min_lr: float, warmup_epochs: int,
                           total_epochs: int, steps_per_epoch: int
                           ) -> torch.optim.lr_scheduler.LambdaLR:
    """Linear warmup from 0 to `lr`, then a half cosine down to `min_lr`
    (the reference's adjust_learning_rate, train.py:117-130), with the
    values of the JAX `warmup_cosine_schedule` (optax's linear, cosine-decay
    and joined schedules, :42-52) at every step.  Sets the optimizer's lr to
    `lr` and returns a `LambdaLR` over it: call its `step()` after each
    train step, so that update k takes the schedule's value at k, as optax
    evaluates it at the update count.  The CLIs leave it off: the reference
    trains at a constant lr (its call is commented out, train.py:303)."""
    warmup = max(warmup_epochs * steps_per_epoch, 1)
    decay = max((total_epochs - warmup_epochs) * steps_per_epoch, 1)
    alpha = min_lr / max(lr, 1e-12)
    f32 = np.float32  # optax computes its schedules in fp32

    def value(step: int) -> float:
        if step < warmup:  # optax.linear_schedule(0, lr, warmup)
            frac = f32(1) - f32(step) / f32(warmup)
            return float(f32(-lr) * frac + f32(lr))
        k = f32(min(step - warmup, decay))  # optax.cosine_decay_schedule
        # cos correctly rounded to fp32, as XLA's is
        cos = f32(math.cos(f32(math.pi) * k / f32(decay)))
        cosine = f32(0.5) * (f32(1) + cos)
        return float(f32(lr) * (f32(1 - alpha) * cosine + f32(alpha)))

    for group in optimizer.param_groups:
        group["lr"] = lr
        group.pop("initial_lr", None)
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: value(step) / lr if lr else 0.0)


def create_train_state(model: nn.Module,
                       optimizer: torch.optim.Optimizer) -> TrainState:
    return TrainState(step=0, model=model, optimizer=optimizer,
                      ema_params={n: p.detach().clone()
                                  for n, p in model.named_parameters()})


@torch.no_grad()
def ema_update(ema_params: Dict[str, torch.Tensor], model: nn.Module,
               decay: float = 0.9999) -> None:
    """ema = ema * decay + p * (1 - decay), in place."""
    for name, p in model.named_parameters():
        e = ema_params[name]
        e.copy_(e * decay + p * (1.0 - decay))


@torch.no_grad()
def clip_by_global_norm(params: Iterable[nn.Parameter],
                        max_norm: float, tp_group=None,
                        sharded: Optional[Iterable[bool]] = None
                        ) -> torch.Tensor:
    """Scale every gradient by min(1, max_norm / max(norm, 1e-12)), the JAX
    formula, in place; returns the norm before clipping.  Parameters
    without a gradient count as zero.  With `tp_group`, the parameters
    marked in `sharded` are a rank's shards: their squares are summed over
    the group, the others' (the same on every rank) counted once."""
    params = list(params)
    grads = [p.grad for p in params if p.grad is not None]
    if tp_group is None:
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in grads]))
    else:
        # [replicated, sharded] squares; a shard's are summed over the group
        sq = [torch.zeros((), device=grads[0].device) for _ in range(2)]
        for p, shard in zip(params, sharded):
            if p.grad is not None:
                sq[shard] = sq[shard] + p.grad.float().square().sum()
        norm = torch.sqrt(sq[0] + group_sum(sq[1], tp_group))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


@torch.no_grad()
def all_reduce_mean(params, loss, group) -> torch.Tensor:
    """Average every parameter's gradient and the loss over `group` in one
    flattened all-reduce (the JAX `lax.pmean` of both); returns the mean
    loss.  Every parameter must have a gradient."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [loss.reshape(1).float()])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat[offset]


def make_train_step(model: nn.Module, transport, optimizer:
                    torch.optim.Optimizer, max_grad_norm: float = 1.0,
                    ema_decay: float = 0.9999, use_labels: bool = True,
                    grad_accum: int = 1, group=None,
                    tp_group=None) -> Callable:
    """Returns train_step(state, x, y, generator) -> {"loss", "grad_norm"}
    (device scalars; reading them waits for the step).

    The loss is the mean of the transport's per-sample loss with the model
    in training mode (label dropout, stochastic depth), every draw taken
    from `generator` on x's device.  grad_accum > 1 splits the batch into
    that many equal micro-batches, in order, and feeds the mean of their
    gradients (and losses) to one update, as the JAX step does
    (:126-167); peak activation memory is then one micro-batch's.

    `group` (a `torch.distributed` process group) makes it the
    data-parallel step: x and y are this rank's slice of the global batch,
    `generator` this rank's, and the gradients (accumulated over the
    micro-batches first) and the loss are averaged over the group before
    the update (`all_reduce_mean`).  The step then equals one process
    stepping every rank's micro-batches in turn with the same draws, up to
    the order of the sums.  `tp_group` (the model built with it) makes the
    clip's norm the whole model's (see the module docstring)."""
    from dimsum_torch.parallel.mesh import is_sharded

    named = list(model.named_parameters())
    params = [p for _, p in named]
    sharded = [is_sharded(n) for n, _ in named]

    def micro_loss(x, y, generator):
        def model_fn(xt, t, **kw):
            return model(xt, t, train=True, generator=generator, **kw)

        kwargs = {"y": y} if use_labels else {}
        return transport.training_losses(model_fn, x, generator,
                                         kwargs)["loss"].mean()

    def train_step(state: TrainState, x, y,
                   generator: Optional[torch.Generator] = None):
        for p in params:
            p.grad = None
        if grad_accum > 1:
            if x.shape[0] % grad_accum:
                raise ValueError(f"batch {x.shape[0]} not divisible by "
                                 f"grad_accum {grad_accum}")
            loss = 0.0
            ys = y.chunk(grad_accum) if y is not None else [None] * grad_accum
            for xi, yi in zip(x.chunk(grad_accum), ys):
                loss_i = micro_loss(xi, yi, generator)
                loss_i.backward()
                loss = loss + loss_i.detach()
            loss = loss / grad_accum
            with torch.no_grad():
                for p in params:
                    if p.grad is not None:
                        p.grad.div_(grad_accum)
        else:
            loss = micro_loss(x, y, generator)
            loss.backward()
            loss = loss.detach()
        for p in params:
            if p.grad is None:  # as optax, which steps every parameter
                p.grad = torch.zeros_like(p)
        if group is not None:
            loss = all_reduce_mean(params, loss, group)
        grad_norm = clip_by_global_norm(params, max_grad_norm, tp_group,
                                        sharded)
        optimizer.step()
        ema_update(state.ema_params, model, ema_decay)
        state.step += 1
        return {"loss": loss, "grad_norm": grad_norm}

    return train_step
