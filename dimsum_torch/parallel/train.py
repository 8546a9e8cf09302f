"""Flow-matching train step on one device, port of
`dimsum_tpu/parallel/train.py` (:23-181) without the mesh: AdamW, global-
norm clipping, EMA and gradient accumulation.

    state = create_train_state(model, create_optimizer(model))
    step = make_train_step(model, transport, state.optimizer)
    metrics = step(state, x, y, generator)

The model holds the fp32 master parameters (`build_dim(..., train=True)`);
the optimizer holds the AdamW moments; `TrainState.ema_params` the EMA
copy.  Parameters are updated in place, which the JAX step gets by donating
its state.  A parameter that takes no gradient in a step (CondMamba's
`cond_proj`, which stays out of the graph) gets a zero gradient before the
update, so that AdamW steps it as optax steps every parameter: its moments
decay, and weight decay shrinks it.  DDP and remat are not ported yet;
checkpoints are `dimsum_torch.utils.ckpt`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional

import torch
import torch.nn as nn


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
                        max_norm: float) -> torch.Tensor:
    """Scale every gradient by min(1, max_norm / max(norm, 1e-12)), the JAX
    formula, in place; returns the norm before clipping.  Parameters
    without a gradient count as zero."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


def make_train_step(model: nn.Module, transport, optimizer:
                    torch.optim.Optimizer, max_grad_norm: float = 1.0,
                    ema_decay: float = 0.9999, use_labels: bool = True,
                    grad_accum: int = 1) -> Callable:
    """Returns train_step(state, x, y, generator) -> {"loss", "grad_norm"}
    (device scalars; reading them waits for the step).

    The loss is the mean of the transport's per-sample loss with the model
    in training mode (label dropout, stochastic depth), every draw taken
    from `generator` on x's device.  grad_accum > 1 splits the batch into
    that many equal micro-batches, in order, and feeds the mean of their
    gradients (and losses) to one update, as the JAX step does
    (:126-167); peak activation memory is then one micro-batch's."""
    params = list(model.parameters())

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
        grad_norm = clip_by_global_norm(params, max_grad_norm)
        optimizer.step()
        ema_update(state.ema_params, model, ema_decay)
        state.step += 1
        return {"loss": loss, "grad_norm": grad_norm}

    return train_step
