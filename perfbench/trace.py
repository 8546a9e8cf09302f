"""The profiled windows: the device's kernels, busy time and idle gaps from
`torch.profiler`'s CUDA activity.

`CLASSES` and `kernel_class` are frozen from `dimsum_torch/
profile_forward.py` at commit 47e520a (the port's kernel classes by name;
"other" is PyTorch's elementwise work, copies and reductions); the idle
share is the same arithmetic, 1 - busy / window, with the busy time the
union of the device's activity (kernels, copies, sets) and the window the
host's span around the calls, ended by a synchronise (`profile_window`)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

CLASSES = (
    ("selective_scan", ("scan_fwd_kernel", "scan_fwd_combine_kernel")),
    ("selective_scan_fwd_train", ("scan_fwd_train_kernel",
                                  "scan_fwd_train_states_kernel",
                                  "scan_fwd_train_combine_kernel")),
    ("selective_scan_bwd", ("scan_bwd_kernel", "scan_bwd_carry_kernel")),
    ("full_block_attention", ("attn_sm90_kernel", "attn_fp32_sm90_kernel",
                              "attn_bf16_kernel", "attn_f32_kernel")),
    # before the library classes: these names hold none of their keys
    ("add_norm", ("add_norm_kernel",)),
    ("norm_modulate", ("norm_mod_kernel",)),
    ("conv_xproj", ("conv_xproj_sm90_kernel", "conv_xproj_f32_kernel")),
    ("optimizer", ("multi_tensor_apply",)),
    ("attention", ("flash", "fmha", "attention", "attn")),
    ("matmul", ("gemm", "nvjet", "sm90_xmma", "cutlass", "cublas")),
)

WINDOW = "perfbench.window"


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


@dataclasses.dataclass
class Trace:
    window_s: float                       # the profiled window's length
    busy_s: float                         # device activity inside it
    calls: int                            # drift calls or steps in it
    kernels: List[Tuple[str, str, float]]  # (name, class, seconds)
    gaps: List[Tuple[str, float]]         # (what the host did, seconds)

    def device_s(self, *classes: str) -> float:
        return sum(s for _, c, s in self.kernels if c in classes)

    def launches(self, *classes: str) -> int:
        return sum(1 for _, c, _ in self.kernels
                   if not classes or c in classes)

    def breakdown(self) -> Dict[str, list]:
        """The device operations that took most time (by class; PyTorch's
        own kernels by name) and the longest idle gaps by what the host
        was doing, 10 of each, in seconds over the window."""
        ops: Dict[str, float] = {}
        for name, cls, s in self.kernels:
            key = cls if cls != "other" else "other:" + name[:80]
            ops[key] = ops.get(key, 0.0) + s
        gaps: Dict[str, float] = {}
        for label, s in self.gaps:
            gaps[label] = gaps.get(label, 0.0) + s
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in idle]}


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _device_events(prof):
    """(name, start us, end us) of the device's activity in a session."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name != WINDOW and e.time_range.end > e.time_range.start]


def profile_window(run: Callable[[], int], run_labelled: Callable[[], int]
                   ) -> Trace:
    """Two profiled windows of a few calls each, each `run` making the
    calls and returning their number.

    The first records the device's activity alone (CUDA): the window is
    the host's clock from a synchronise before the first call to the one
    after the last (`run` ends with it), the busy time the union of the
    device's kernels, copies and sets, the kernels by class.  The second
    (`run_labelled`) records the host's operations too, inside one
    `WINDOW` range, to label each idle gap by the innermost host operation
    running at its midpoint; tracing the host slows it, so those gaps
    read longer than they are."""
    import time

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        calls = run()
        window_s = time.perf_counter() - t0
    device = _device_events(prof)
    if not device:
        raise RuntimeError("the trace holds no device activity")
    busy = _merge([(a, b) for _, a, b in device])
    busy_s = sum(b - a for a, b in busy) / 1e6
    kernels = [(n, kernel_class(n), (b - a) / 1e6) for n, a, b in device
               if not n.startswith(("Memcpy", "Memset"))]

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            run_labelled()
    events = prof.events()
    win = [e for e in events if e.name == WINDOW
           and e.device_type == DeviceType.CPU]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} window ranges")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    spans = _merge([(max(a, w0), min(b, w1))
                    for _, a, b in _device_events(prof) if b > w0 and a < w1])
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CPU and e.name != WINDOW
            and e.time_range.end > e.time_range.start]
    edges = [w0] + [x for ab in spans for x in ab] + [w1]
    holes = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
             if edges[i + 1] > edges[i]]
    holes = sorted(holes, key=lambda ab: ab[0] - ab[1])[:200]
    hs = np.array([a for a, _, _ in host]) if host else np.zeros(0)
    he = np.array([b for _, b, _ in host]) if host else np.zeros(0)
    gaps = []
    for a, b in holes:
        m = 0.5 * (a + b)
        idx = np.nonzero((hs <= m) & (he >= m))[0]
        label = ("host:" + host[idx[np.argmax(hs[idx])]][2][:80]
                 if len(idx) else "host:none")
        gaps.append((label, (b - a) / 1e6))
    return Trace(window_s=window_s, busy_s=busy_s, calls=calls,
                 kernels=kernels, gaps=gaps)
