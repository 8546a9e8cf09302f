"""Sampling jobs back to back, closed loop: each job is `images` images
(twice as many CFG rows) drawn from the seed, integrated by the port's
Euler sampler (`transport.Sampler.sample_ode`) over `num_steps` grid
points with `forward_with_cfg` over the port's model, as the sampling CLI
runs it.  The window counts whole drift calls; a job runs past the
window's end only as far as the call that closes it.

Correctness: a sample of the window's drift calls, drawn from the seed
(a reservoir of `check.calls`), is held to the reference: the drift that
the port returned against the reference's float32 CFG forward at the same
x, t and y (`drift_err`, the widest gap over the largest value), and the
next state the port's Euler step made from it against x + dt v
(`euler_err`, with the first call's x against the job's noise)."""

from __future__ import annotations

import gc
import math

import numpy as np
import torch

from perfbench import reference
from perfbench.common import Check, Ctx, Window, WindowClosed, derive, mark
from perfbench.counts.model import call_flops, kernel_bounds
from perfbench.entries import port
from perfbench.reference import sampling as ref_sampling
from perfbench.weights import make_weights


class Reservoir:
    """Up to `k` drift calls kept uniformly from all the window's calls
    (reservoir sampling by a host generator seeded from the run's seed),
    each with the next state of its job once the port has made it."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(seed)
        self.slots = []
        self.waiting = None  # the slot whose next state comes next
        self.first = None

    def see(self, i: int, step: int, x, t, y, out):
        if self.waiting is not None:
            self.waiting["x_next"] = x if step > 0 else None
            self.waiting = None
        if i == 0:
            self.first = x
        slot = dict(step=step, x=x, t=t, y=y, out=out, x_next=None)
        if len(self.slots) < self.k:
            self.slots.append(slot)
        else:
            j = int(self.rng.integers(0, i + 1))
            if j >= self.k:
                return
            self.slots[j] = slot
        self.waiting = slot

    def job_done(self, x_final):
        if self.waiting is not None:
            self.waiting["x_next"] = x_final
            self.waiting = None


def job_inputs(cell, cfg, seed: int, j: int, device):
    """Job j's noise (images, C, H, W) and labels, doubled for CFG: rows
    [z; z] with [labels; null]."""
    n, C = cell["images"], cfg["in_channels"]
    s = cfg["img_resolution"]
    g = torch.Generator(device=device).manual_seed(derive(seed, "job", j))
    z = torch.randn((n, C, s, s), generator=g, device=device)
    y = torch.randint(0, cfg["num_classes"], (n,), generator=g,
                      device=device)
    null = torch.full((n,), cfg["num_classes"], device=device)
    return z, torch.cat([z, z]), torch.cat([y, null])


def _sut(cell, cfg, weights, device, sut):
    """(sample(x, model_fn, y) -> x(1), model_call(x, t, y) -> drift) of
    the system under test: the port, or the control (the reference in
    float8 products with a bfloat16 state)."""
    scale, C = cell["cfg_scale"], cfg["in_channels"]
    steps = cell["num_steps"]
    if sut == "port":
        from dimsum_torch.models.dim import forward_with_cfg
        from dimsum_torch.transport import Sampler, create_transport

        net = port.build(cfg, weights, device)
        sampler = Sampler(create_transport(cell["path"], cell["prediction"]))
        sample = sampler.sample_ode(sampling_method=cell["sampling_method"],
                                    num_steps=steps)
        warm = sampler.sample_ode(sampling_method=cell["sampling_method"],
                                  num_steps=3)

        def model_call(x, t, y):
            # the drift is the guided velocity; a learned variance's
            # channels are dropped, as SiT's forward drops them
            return forward_with_cfg(net, x, t, y, cfg_scale=scale,
                                    in_channels=C)[:, :C]

        return (lambda x, fn, y: sample(x, fn, y=y),
                lambda x, fn, y: warm(x, fn, y=y), model_call)
    ctl = reference.model.build(cfg, reference.model.Precision("fp8"))
    ctl.load_state_dict(weights, assign=True)
    block = cell["check"]["block_rows"]

    def model_call(x, t, y):
        with reference.model.fp32_matmul():
            return ref_sampling.cfg_forward(ctl, x, t, y, scale, C, block)

    def run(n_steps):
        return lambda x, fn, y: ref_sampling.euler(
            fn, x, cell["path"], cell["prediction"], n_steps, y,
            torch.bfloat16)

    return run(steps), run(3), model_call


def run(cell, seed: int, seconds: float, trace: bool, device,
        sut: str = "port", setup_clock=None):
    """One run of a sampling cell.  Returns (ctx, checks, attempted,
    failed); `setup_clock()` gives the seconds of set-up so far."""
    cfg = cell["model"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    ref_net = reference.model.build(cfg)
    weights = make_weights(ref_net, derive(seed, "weights"), dev)
    mark("weights")
    sample, warm, model_call = _sut(cell, cfg, weights, dev, sut)
    del weights
    mark("build")
    ctx = Ctx(cell=cell, images_per_call=cell["images"]
              / (cell["num_steps"] - 1), flops_per_call=call_flops(cell, cfg))
    ctx.bounds = kernel_bounds(cell, cfg)
    rec = Reservoir(cell["check"]["calls"], derive(seed, "check"))
    state = dict(step=0, calls=0)

    def timed(window, keep):
        def model_fn(x, t, y=None):
            window.tick()
            out = model_call(x, t, y)
            if keep:
                rec.see(state["calls"], state["step"], x, t, y, out)
            state["calls"] += 1
            state["step"] += 1
            return out
        return model_fn

    def jobs(window, keep, first_job):
        j = first_job
        try:
            while True:
                _, x, y = job_inputs(cell, cfg, seed, j, dev)
                state["step"] = 0
                x_final = sample(x, timed(window, keep), y)
                if keep:
                    rec.job_done(x_final)
                j += 1
        except WindowClosed:
            pass
        return j + 1

    with torch.no_grad():
        _, x, y = job_inputs(cell, cfg, seed, -1, dev)
        warm(x, lambda x_, t_, y=None: model_call(x_, t_, y), y)
        sync()
        mark("warm-up")
        ctx.setup_s = setup_clock() if setup_clock else 0.0
        window = Window(seconds)
        window.start()
        next_job = jobs(window, True, 0)
        ctx.window_s = window.stop(sync)
        ctx.calls = window.calls
        if cuda:
            ctx.counters["memory_peak_bytes"] = float(
                torch.cuda.max_memory_allocated(dev))
        if trace:
            from perfbench.trace import profile_window

            def profiled(calls):
                def go():
                    w = Window(math.inf, calls)
                    w.start()
                    jobs(w, False, next_job)
                    sync()
                    return w.calls
                return go

            ctx.trace = profile_window(profiled(cell["trace_calls"]),
                                       profiled(1))
    del sample, warm, model_call
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = compare(cell, cfg, seed, rec, ref_net, dev)
    return ctx, checks, ctx.calls, 0


def compare(cell, cfg, seed, rec, ref_net, dev):
    """The kept calls against the reference (see the module docstring)."""
    ref_net.load_state_dict(make_weights(ref_net, derive(seed, "weights"),
                                         dev), assign=True)
    ts, dts = ref_sampling.grid(cell["path"], cell["prediction"],
                                cell["num_steps"])
    C, block = cfg["in_channels"], cell["check"]["block_rows"]
    drift_err = drift_rms = euler_err = 0.0
    z0, _, _ = job_inputs(cell, cfg, seed, 0, dev)
    if rec.first is not None:
        first = rec.first.float()
        euler_err = _gap(first, torch.cat([z0, z0]))
    with torch.no_grad(), reference.model.fp32_matmul():
        for s in rec.slots:
            want = ref_sampling.cfg_forward(ref_net, s["x"], s["t"], s["y"],
                                            cell["cfg_scale"], C, block)
            drift_err = max(drift_err, _gap(s["out"], want))
            drift_rms = max(drift_rms, _rms_gap(s["out"], want))
            t_err = float((s["t"].float() - ts[s["step"]]).abs().max())
            euler_err = max(euler_err, t_err)
            if s["x_next"] is not None:
                step = s["x"].float() + dts[s["step"]] * s["out"].float()
                euler_err = max(euler_err, _gap(s["x_next"], step))
    return [Check("drift_err", drift_err, cell["check"]["drift_err"]),
            Check("drift_rms", drift_rms, cell["check"]["drift_rms"]),
            Check("euler_err", euler_err, cell["check"]["euler_err"])]


def _gap(got, want) -> float:
    """max |got - want| / max |want|: the widest gap against the scale of
    the reference (inf where got is not finite)."""
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        return math.inf
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def _rms_gap(got, want) -> float:
    """||got - want|| / ||want||, the 2-norms over the whole call (inf
    where got is not finite)."""
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        return math.inf
    return float((got - want).norm() / want.norm().clamp_min(1e-30))
