"""Collective training-statistics collector, the port of
`dimsum_tpu/utils/training_stats.py`.

Reference: `eval_toolbox/torch_utils/training_stats.py` (report :62,
report0 :113, Collector :123, _sync :250 with its
`torch.distributed.all_reduce` of stacked [num, sum, sum_sq] moments).

  * `report(name, value)` accumulates float64 [num, sum, sum_sq] moments on
    the host; a value may be a Python scalar, a numpy array or a tensor on
    any device (fetched to the host).
  * `moments(t)` is the [num, sum, sum_sq] vector of a tensor on its own
    device (fp32), for a step that sums it over a process group itself;
    `report_moments(name, m)` takes such a vector.
  * `Collector.update()` syncs across processes: with a `torch.distributed`
    process group initialised and more than one rank, the stacked moment
    matrix is all-reduced (every rank must call update() with the same
    names, the reference's contract); a single process skips it.
  * `Collector.num/mean/std/as_dict` as the reference (NaN mean for an
    empty stat, zero std for a single value, the raw variance clamped).
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["report", "report0", "report_moments", "moments", "Collector",
           "reset"]

_NUM_MOMENTS = 3  # [num, sum, sum_sq]

_counters: Dict[str, np.ndarray] = {}   # name -> float64 (3,), since start
_cumulative: Dict[str, np.ndarray] = {}  # name -> float64 (3,), synced


def reset():
    """Clear all accumulated state (test isolation)."""
    _counters.clear()
    _cumulative.clear()


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().to("cpu", torch.float64).numpy()
    return np.asarray(value, np.float64)


def moments(value: torch.Tensor) -> torch.Tensor:
    """[num, sum, sum_sq] of a tensor's values, fp32, on its device."""
    v = value.detach().reshape(-1).float()
    return torch.stack([torch.tensor(float(v.numel()), device=v.device),
                        v.sum(), v.square().sum()])


def report_moments(name: str, m):
    """Accumulate a precomputed [num, sum, sum_sq] vector (host-side)."""
    m = _host(m)
    assert m.shape == (_NUM_MOMENTS,)
    if name not in _counters:
        _counters[name] = np.zeros(_NUM_MOMENTS, np.float64)
    _counters[name] += m
    return m


def report(name: str, value):
    """Accumulate a set of scalars under `name` (reference report :62).
    Returns `value` so it can be used inline."""
    elems = _host(value).ravel()
    if name not in _counters:
        _counters[name] = np.zeros(_NUM_MOMENTS, np.float64)
    if elems.size:
        _counters[name] += np.array(
            [elems.size, elems.sum(), np.square(elems).sum()], np.float64)
    return value


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def report0(name: str, value):
    """Accumulate only on rank 0 (reference report0 :113)."""
    report(name, value if _rank() == 0 else [])
    return value


def _sync(names: List[str]) -> List[Tuple[str, np.ndarray]]:
    """Sum the ranks' deltas and fold them into the cumulative counters
    (reference _sync :250).  Collective when a process group of more than
    one rank is initialised: float64 on the card for NCCL, on the host for
    gloo."""
    if not names:
        return []
    deltas = np.stack([
        _counters.get(n, np.zeros(_NUM_MOMENTS, np.float64)) for n in names
    ])
    for n in names:
        _counters[n] = np.zeros(_NUM_MOMENTS, np.float64)
    if dist.is_initialized() and dist.get_world_size() > 1:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        t = torch.from_numpy(deltas).to(dev)
        dist.all_reduce(t)
        deltas = t.cpu().numpy()
    for i, n in enumerate(names):
        if n not in _cumulative:
            _cumulative[n] = np.zeros(_NUM_MOMENTS, np.float64)
        _cumulative[n] += deltas[i]
    return [(n, _cumulative[n]) for n in names]


class Collector:
    """Windowed mean/std view over `report()`ed stats (reference :123)."""

    def __init__(self, regex: str = ".*", keep_previous: bool = True):
        self._regex = re.compile(regex)
        self._keep_previous = keep_previous
        self._cumulative: Dict[str, np.ndarray] = {}
        self._moments: Dict[str, np.ndarray] = {}
        self.update()
        self._moments.clear()

    def names(self):
        return [n for n in _counters if self._regex.fullmatch(n)]

    def update(self):
        if not self._keep_previous:
            self._moments.clear()
        for name, cumulative in _sync(self.names()):
            prev = self._cumulative.get(
                name, np.zeros(_NUM_MOMENTS, np.float64))
            delta = cumulative - prev
            self._cumulative[name] = cumulative.copy()
            if delta[0] != 0:
                self._moments[name] = delta

    def _get_delta(self, name):
        assert self._regex.fullmatch(name)
        return self._moments.get(name, np.zeros(_NUM_MOMENTS, np.float64))

    def num(self, name) -> int:
        return int(self._get_delta(name)[0])

    def mean(self, name) -> float:
        d = self._get_delta(name)
        return float("nan") if d[0] == 0 else float(d[1] / d[0])

    def std(self, name) -> float:
        d = self._get_delta(name)
        if d[0] == 0 or not np.isfinite(d[1]):
            return float("nan")
        if int(d[0]) == 1:
            return 0.0
        mean = d[1] / d[0]
        raw_var = d[2] / d[0]
        return float(np.sqrt(max(raw_var - mean * mean, 0.0)))

    def as_dict(self):
        return {
            name: dict(num=self.num(name), mean=self.mean(name),
                       std=self.std(name))
            for name in self.names()
        }

    def __getitem__(self, name):
        return self.mean(name)
