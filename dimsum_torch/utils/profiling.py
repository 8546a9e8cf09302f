"""Tracing and profiling helpers, the port of `dimsum_tpu/utils/profiling.py`.

  * `trace(logdir)`: a `torch.profiler` session over the host and the card,
    written to `logdir` as a trace that TensorBoard's profiler plugin (or
    Perfetto) shows.
  * `sync` / `timed`: wall-clock timing with `torch.cuda.synchronize`, so
    the time covers the card's work and not only its enqueueing.
  * `flops` / `memory` take the place of the JAX `xla_flops` /
    `xla_memory` (XLA's analysis of a compiled program): the operations
    `torch.utils.flop_counter.FlopCounterMode` counts, and the card
    allocator's peak over a call.
  * `MetricLogger`: windowed means of logged scalars.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import numpy as np
import torch

__all__ = ["trace", "sync", "timed", "flops", "memory", "MetricLogger"]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block's host and card activity (CUDA where a card is
    present) and write the trace to `logdir`; yields the profiler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def _cuda_devices(tree):
    """The CUDA devices of the tensors in a nested tuple / list / dict."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(_cuda_devices(t) for t in tree))
    return set()


def sync(tree=None) -> None:
    """Wait for the card's work: `torch.cuda.synchronize` on each device
    a tensor of `tree` lives on (the current device for None; nothing for
    CPU tensors)."""
    if tree is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return
    for dev in _cuda_devices(tree):
        torch.cuda.synchronize(dev)


def timed(fn: Callable, *args, iters: int = 10, warmup: int = 1,
          **kwargs) -> float:
    """Seconds per call of fn(*args, **kwargs), the card synchronised
    before and after the timed calls."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    sync(out if out is not None else args)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    sync(out)
    return (time.perf_counter() - t0) / iters


def flops(fn: Callable, *args, **kwargs) -> float:
    """The floating-point operations of fn(*args, **kwargs) as
    `torch.utils.flop_counter.FlopCounterMode` counts them: matrix
    products, convolutions and attention, 2 m n k a product (the
    reference's calflops convention).  The port's kernels launch through
    ctypes and are invisible to the counter, so count on their plain
    routes; XLA's count (the JAX `xla_flops`) also includes elementwise
    work."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def memory(fn: Callable, *args, **kwargs) -> dict:
    """The card allocator's bytes over one call of fn(*args, **kwargs) on
    the current device: `peak_bytes` (torch.cuda.max_memory_allocated, the
    peak reset just before, so what was allocated then counts), and
    `before_bytes` / `after_bytes` allocated around the call.  Needs a
    card."""
    if not torch.cuda.is_available():
        raise RuntimeError("memory() reads the card's allocator; CUDA is "
                           "not available")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    rec = {"peak_bytes": torch.cuda.max_memory_allocated(),
           "before_bytes": before,
           "after_bytes": torch.cuda.memory_allocated()}
    del out
    return rec


class MetricLogger:
    """Smoothed-scalar logger (the reference's dimsum/utils.py
    MetricLogger), windowed means for steady-rate reporting."""

    def __init__(self, window: int = 20):
        self.window = window
        self.series: dict = {}

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.series.setdefault(k, []).append(float(v))
            if len(self.series[k]) > 10 * self.window:
                self.series[k] = self.series[k][-self.window:]

    def mean(self, key: str) -> float:
        vals = self.series.get(key, [])
        return float(np.mean(vals[-self.window:])) if vals else float("nan")

    def global_mean(self, key: str) -> float:
        vals = self.series.get(key, [])
        return float(np.mean(vals)) if vals else float("nan")

    def __str__(self):
        return " ".join(f"{k}={self.mean(k):.4f}" for k in self.series)
