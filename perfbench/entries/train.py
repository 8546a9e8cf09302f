"""Training steps back to back, closed loop, as the training CLI runs them
(`dimsum_torch/train.py::Trainer`): a latent memmap of `samples` seeded
rows (written at set-up into a fresh directory under TMPDIR) read by
`data.LatentMemmapDataset` through `data.Loader` (shuffle on, the CLI's
worker threads and prefetch) and `data.device_batches`, each batch stepped
by `parallel.make_train_step` (the flow-matching loss, backward, the
global-norm clip, AdamW, EMA) with the step's draws from one generator.

Set-up builds that one step, model and optimizer state, drives it
through its first `check.steps` steps on the loader's first batches (the
check) and one more, and hands the same objects to the window, which
counts whole steps and times the benchmark's span around each `next()`
on the batches.

Correctness: the reference (`reference/train.py`) reads the same batches
from the file by the loader's order and follows those first steps from
the same weights with the same draws.  Compared: each step's loss
(`loss_err`, relative), the first step's gradient as AdamW got it, read
back from its first moment (`grad_err`, the worst leaf's gap of norms),
and each leaf's change after the checked steps (`change_err`, the worst
leaf's gap of norms; leaves whose reference gradient is under a
thousandth of the median leaf's left out), and each leaf's EMA change
after them (`ema_med`, the median leaf's gap of norms of the port's EMA
less the weights against the reference's EMA carried from the same
weights; not the worst leaf's: three steps move an EMA of decay 0.9999
by less than the float32 rounding of leaves whose values are near 1, such
as A_log, the norm weights and the position table, so that leaf's gap
is the port's rounding)."""

from __future__ import annotations

import gc
import math
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from perfbench import reference
from perfbench.common import Check, Ctx, Window, WindowClosed, derive, mark
from perfbench.counts.model import call_flops, kernel_bounds
from perfbench.entries import port
from perfbench.reference import train as ref_train
from perfbench.weights import make_weights


def write_data(cell, cfg, seed: int, device, directory: str):
    """`samples` latents ~ N(0, 1) and int64 labels, drawn on the device
    from the seed and written as the preprocessing CLI lays them out
    (latents.dat, labels.dat)."""
    n, C, s = cell["samples"], cfg["in_channels"], cfg["img_resolution"]
    g = torch.Generator(device=device).manual_seed(derive(seed, "data"))
    x = torch.randn((n, C, s, s), generator=g, device=device)
    y = torch.randint(0, cfg["num_classes"], (n,), generator=g,
                      device=device)
    x.cpu().numpy().tofile(os.path.join(directory, "latents.dat"))
    y.cpu().numpy().astype(np.int64).tofile(
        os.path.join(directory, "labels.dat"))


def loader_seed(seed: int) -> int:
    return derive(seed, "loader") % 2 ** 31


def run(cell, seed: int, seconds: float, trace: bool, device,
        sut: str = "port", setup_clock=None):
    """One run of a training cell.  Returns (ctx, checks, attempted,
    failed)."""
    directory = tempfile.mkdtemp(prefix="perfbench-")
    try:
        return _run(cell, seed, seconds, trace, torch.device(device), sut,
                    setup_clock, directory)
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def _run(cell, seed, seconds, trace, dev, sut, setup_clock, directory):
    cfg = cell["model"]
    tr = cell["config_file"]["training"]
    cuda = dev.type == "cuda"
    write_data(cell, cfg, seed, dev, directory)
    mark("data")
    ref_net = reference.model.build(cfg)
    ctx = Ctx(cell=cell, images_per_call=cell["batch"],
              flops_per_call=call_flops(cell, cfg))
    ctx.bounds = kernel_bounds(cell, cfg)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    if sut == "port":
        prog = _port_steps(cell, cfg, tr, seed, dev, directory, ref_net)
        checked, draws_states, it, step_fn = prog
        ctx.setup_s = setup_clock() if setup_clock else 0.0
        if cuda:
            ctx.counters["memory_peak_bytes"] = float(
                torch.cuda.max_memory_allocated(dev))
            torch.cuda.reset_peak_memory_stats(dev)
        waits = ctx.spans.setdefault("loader_wait", [])

        def loop(window, spans):
            try:
                while True:
                    window.tick()
                    t0 = time.perf_counter()
                    x, y = next(it)
                    if spans is not None:
                        spans.append(time.perf_counter() - t0)
                    step_fn(x, y)
            except WindowClosed:
                pass

        window = Window(seconds)
        window.start()
        loop(window, waits)
        ctx.window_s = window.stop(sync)
        ctx.calls = window.calls
        if cuda:
            peak = float(torch.cuda.max_memory_allocated(dev))
            ctx.counters["window_memory_peak_bytes"] = peak
            ctx.counters["memory_peak_bytes"] = max(
                peak, ctx.counters["memory_peak_bytes"])
        if trace:
            from perfbench.trace import profile_window

            def profiled(calls):
                def go():
                    w = Window(math.inf, calls)
                    w.start()
                    loop(w, None)
                    sync()
                    return w.calls
                return go

            ctx.trace = profile_window(profiled(cell["trace_calls"]),
                                       profiled(1))
        it.close()
        del it, step_fn, prog
    else:
        checked, draws_states = _control_steps(cell, cfg, tr, seed, dev,
                                               directory)
        ctx.counters["memory_peak_bytes"] = 0.0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = compare(cell, cfg, tr, seed, dev, directory, ref_net, checked,
                     draws_states)
    return ctx, checks, ctx.calls, 0


def _batches(loader, dev):
    """The loader's device batches, epoch after epoch."""
    from dimsum_torch.data import device_batches

    epoch = 0
    while True:
        loader.set_epoch(epoch)
        yield from device_batches(loader, dev)
        epoch += 1


def _port_steps(cell, cfg, tr, seed, dev, directory, ref_net):
    """Set-up: the port's data, model, optimizer and step, driven through
    the checked steps and one more.  Returns ((losses, first-step
    gradient norms, changes, EMA changes), the generator states before
    the checked steps, the batch iterator, step(x, y))."""
    from dimsum_torch.data import LatentMemmapDataset, Loader
    from dimsum_torch.parallel import (create_optimizer, create_train_state,
                                       make_train_step)
    from dimsum_torch.transport import create_transport

    s = cfg["img_resolution"]
    dataset = LatentMemmapDataset(
        os.path.join(directory, "latents.dat"),
        os.path.join(directory, "labels.dat"),
        latent_shape=(cfg["in_channels"], s, s))
    loader = Loader(dataset, cell["batch"], shuffle=True,
                    seed=loader_seed(seed), num_workers=cell["num_workers"])
    weights = make_weights(ref_net, derive(seed, "weights"), dev)
    mark("weights")
    net = port.build(cfg, weights, dev, train=True)
    mark("build")
    transport = create_transport(tr["path"], tr["prediction"],
                                 t_sample_mode=tr["t_sample_mode"])
    optimizer = create_optimizer(net, lr=tr["lr"],
                                 weight_decay=tr["weight_decay"],
                                 betas=tuple(tr["betas"]))
    state = create_train_state(net, optimizer)
    step = make_train_step(net, transport, optimizer,
                           max_grad_norm=tr["max_grad_norm"],
                           ema_decay=tr["ema_decay"], use_labels=True)
    gen = torch.Generator(device=dev).manual_seed(derive(seed, "draws"))

    def step_fn(x, y):
        return step(state, x, y, gen)

    it = _batches(loader, dev)
    named = list(net.named_parameters())
    losses, states = [], []
    b1 = tr["betas"][0]
    for k in range(cell["check"]["steps"]):
        x, y = next(it)
        states.append(gen.get_state())
        losses.append(step_fn(x, y)["loss"])
        if k == 0:
            g1 = {n: (optimizer.state[p]["exp_avg"] / (1 - b1)).norm()
                  for n, p in named}
    with torch.no_grad():
        change = {n: (p - weights[n]).norm() for n, p in named}
        ema = {n: (state.ema_params[n].double() - weights[n].double())
               .norm() for n, _ in named}
    del weights
    step_fn(*next(it))   # one more before the window
    mark("checked steps")
    checked = ([float(v) for v in losses], g1, change, ema)
    return checked, states, it, step_fn


def _control_steps(cell, cfg, tr, seed, dev, directory):
    """The control in the port's place: the reference's steps with every
    Linear's operands in float8, on the reference's own reading of the
    batches."""
    ctl = reference.model.build(cfg, reference.model.Precision("fp8"))
    ctl.load_state_dict(make_weights(ctl, derive(seed, "weights"), dev),
                        assign=True)
    batches = _ref_batches(cell, cfg, seed, dev, directory)
    gen = torch.Generator(device=dev).manual_seed(derive(seed, "draws"))
    states = []
    for x1, y in batches:
        states.append(gen.get_state())
        ref_train.draws(gen, x1, y, cfg)
    with reference.model.fp32_matmul():
        losses, g1, _, change, ema = ref_train.steps(
            ctl, batches, states, cfg, tr, cell["check"]["block_rows"])
    return (losses, g1, change, ema), states


def _ref_batches(cell, cfg, seed, dev, directory):
    """The first `check.steps` batches, read from the file in the
    loader's order."""
    s = cfg["img_resolution"]
    n = cell["samples"]
    xs = np.memmap(os.path.join(directory, "latents.dat"), np.float32, "r",
                   shape=(n, cfg["in_channels"], s, s))
    ys = np.memmap(os.path.join(directory, "labels.dat"), np.int64, "r",
                   shape=(n,))
    order = ref_train.epoch_batches(n, cell["batch"], loader_seed(seed), 0)
    return [(torch.from_numpy(np.ascontiguousarray(xs[b])).to(dev),
             torch.from_numpy(np.ascontiguousarray(ys[b])).to(dev))
            for b in order[:cell["check"]["steps"]]]


def compare(cell, cfg, tr, seed, dev, directory, ref_net, checked,
            states):
    """The checked steps against the reference (module docstring)."""
    ref_net.load_state_dict(make_weights(ref_net, derive(seed, "weights"),
                                         dev), assign=True)
    batches = _ref_batches(cell, cfg, seed, dev, directory)
    with reference.model.fp32_matmul():
        losses, g1, g1_raw, change, ema = ref_train.steps(
            ref_net, batches, states, cfg, tr, cell["check"]["block_rows"])
    got_losses, got_g1, got_change, got_ema = checked
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(got_losses, losses))
    if not all(math.isfinite(a) for a in got_losses):
        loss_err = math.inf
    names = list(g1)
    moved = torch.stack([g1_raw[n] >= 1e-3 * torch.stack(
        list(g1_raw.values())).median() for n in names]).cpu()

    def vec(d):
        return torch.stack([d[n].float() for n in names]).cpu()

    chk = cell["check"]
    grad_err, grad_med = ref_train.leaf_gaps(vec(got_g1), vec(g1))
    change_err, change_med = ref_train.leaf_gaps(vec(got_change),
                                                 vec(change), moved)
    _, ema_med = ref_train.leaf_gaps(vec(got_ema), vec(ema), moved)
    return [Check("loss_err", loss_err, chk["loss_err"]),
            Check("grad_err", grad_err, chk["grad_err"]),
            Check("grad_med", grad_med, chk["grad_med"]),
            Check("change_err", change_err, chk["change_err"]),
            Check("change_med", change_med, chk["change_med"]),
            Check("ema_med", ema_med, chk["ema_med"])]
