"""The reference's side of a training cell: the loader's batches read
again from the file by the loader's documented order, and three training
steps of the plain model from the same weights with the same draws.

Frozen from the port at commit 47e520a: the epoch order of
`dimsum_torch/data/loader.py::Loader` (a permutation from
`numpy.random.default_rng(seed * 100_003 + epoch)`, whole batches in
order), the draws of `transport.Transport.sample` and of the model in
training (`make_train_step`: x0 ~ N(0, 1) like the batch, t uniform in
[0, 1), each label dropped with probability `label_dropout`, then one
stochastic-depth draw a block from block 1 on whose rate is above 0, in
block order, all from the step's generator), the GVP plan and the
flow-matching loss with velocity prediction, the global-norm clip, and
AdamW (optax's, wd 0) and the EMA of the parameters after each step,
written out.  The model is `model.RefDiM`; the
draws are replayed from the generator's state before each step, so the
reference sees the numbers the port drew, in the port's order.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch


def epoch_batches(n: int, batch: int, seed: int, epoch: int) -> List:
    """The row indices of each batch of an epoch, as the loader orders
    them (one shard, drop_last)."""
    idx = np.arange(n)
    np.random.default_rng(seed * 100_003 + epoch).shuffle(idx)
    nb = n // batch
    return [idx[i * batch:(i + 1) * batch] for i in range(nb)]


def draws(gen, x1, y, cfg):
    """(x0, t, dropped labels, per-block keep scales) drawn from `gen` in
    the port's order."""
    B = x1.shape[0]
    dev = x1.device
    x0 = torch.randn(x1.shape, generator=gen, device=dev, dtype=x1.dtype)
    t = torch.rand(B, generator=gen, device=dev) * (1.0 - 0.0) + 0.0
    if cfg["label_dropout"] > 0:
        drop = torch.rand(y.shape, generator=gen, device=dev) < \
            cfg["label_dropout"]
        y = torch.where(drop, cfg["num_classes"], y)
    depth = cfg["depth"]
    rates = [0.0] + np.linspace(0.0, cfg["drop_path"], depth).tolist()
    keeps = []
    for i in range(depth):
        if i > 0 and rates[i] > 0.0:
            keep = 1.0 - rates[i]
            mask = torch.rand((B, 1, 1), generator=gen, device=dev) < keep
            keeps.append(mask.float().reshape(B) / keep)
        else:
            keeps.append(None)
    return x0, t, y, keeps


def loss_and_grads(model, x1, y, gen, cfg, block: int):
    """The mean flow-matching loss of a batch (GVP path, velocity) and its
    gradients in the parameters' .grad, `block` rows at a time."""
    x0, t, y, keeps = draws(gen, x1, y, cfg)
    B = x1.shape[0]
    te = t.reshape(B, 1, 1, 1)
    a = te * math.pi / 2
    xt = torch.sin(a) * x1 + torch.cos(a) * x0
    ut = math.pi / 2 * torch.cos(a) * x1 - math.pi / 2 * torch.sin(a) * x0
    total = torch.zeros((), device=x1.device)
    for i in range(0, B, block):
        s = slice(i, i + block)
        pred = model(xt[s], t[s], y[s],
                     keeps=[None if k is None else k[s] for k in keeps])
        part = ((pred - ut[s]) ** 2).mean(dim=(1, 2, 3)).sum() / B
        part.backward()
        total = total + part.detach()
    return total


def steps(model, batches, gen_states, cfg, tr, block: int):
    """Three (or len(batches)) training steps of `model` from its
    weights: returns (losses, the first step's clipped gradient norms by
    leaf, its unclipped ones, the change of each leaf after the last
    step, the change of each leaf's EMA after it), each norm a
    {parameter name: 0-d tensor}.  The EMA (ema = d ema + (1 - d) p,
    from the weights) is carried as its change from the weights,
    d (ema - w0) + (1 - d)(p - w0), so that no rounding at the weights'
    size swamps it."""
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    p0 = [p.detach().clone() for p in params]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    ema = [torch.zeros_like(p) for p in params]
    d = tr["ema_decay"]
    b1, b2 = tr["betas"]
    losses, g1, g1_raw = [], None, None
    for k, ((x1, y), state) in enumerate(zip(batches, gen_states)):
        for p in params:
            p.grad = None
        gen = torch.Generator(device=x1.device)
        gen.set_state(state)
        losses.append(float(loss_and_grads(model, x1, y, gen, cfg, block)))
        with torch.no_grad():
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in params]
            norms = torch.stack([g.norm() for g in grads])
            norm = norms.square().sum().sqrt()
            scale = torch.clamp(tr["max_grad_norm"] / norm.clamp_min(1e-12),
                                max=1.0)
            if k == 0:
                g1_raw, g1 = norms, norms * scale
            step = k + 1
            for p, g, mi, vi in zip(params, grads, m, v):
                g = g * scale
                mi.mul_(b1).add_((1 - b1) * g)
                vi.mul_(b2).add_((1 - b2) * g * g)
                mh = mi / (1 - b1 ** step)
                vh = vi / (1 - b2 ** step)
                p.sub_(tr["lr"] * mh / (vh.sqrt() + tr["eps"]))
            for p, q, e in zip(params, p0, ema):
                e.mul_(d).add_((1 - d) * (p - q))
    with torch.no_grad():
        change = [(p - q).norm() for p, q in zip(params, p0)]
        ema_change = [e.norm() for e in ema]
    for p in params:
        p.grad = None

    def named(values):
        return dict(zip(names, values))

    return (losses, named(g1), named(g1_raw), named(change),
            named(ema_change))


def leaf_gaps(got, want, mask=None):
    """(the worst leaf's, the median leaf's) gap between two norms,
    |got - want|, against the reference's norm of that leaf or of the
    median leaf, whichever is larger; leaves outside `mask` left out."""
    got, want = got.float(), want.float()
    if mask is not None:
        got, want = got[mask], want[mask]
    if not bool(torch.isfinite(got).all()):
        return math.inf, math.inf
    gaps = (got - want).abs() / torch.maximum(want, want.median())
    return float(gaps.max()), float(gaps.median())
