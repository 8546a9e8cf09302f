"""What every entry of the benchmark shares: the files found by name, the
seeds derived from `--seed`, the run's context that the metric readers
read, and the window that counts whole calls."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parent           # perfbench/
CHECKOUT = ROOT.parent                           # the checkout's root
BUILD = CHECKOUT / "build" / "perfbench"         # caches, git-ignored


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(CHECKOUT / "BENCHMARK.json")


def load_cell(name: str) -> dict:
    """The cell's file `workloads/<name>.json` and its configuration's
    `configs/<config>.json`, found by name."""
    cell = load_json(ROOT / "workloads" / f"{name}.json")
    cell["name"] = name
    cell["config_file"] = load_json(
        ROOT / "configs" / f"{cell['config']}.json")
    cell["model"] = model_fields(cell)
    return cell


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one use (`tags`) of the run's `--seed`: the
    weights, each job's inputs, the data, the draws, the sample that is
    checked."""
    text = ":".join(str(t) for t in (int(seed), *tags))
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def model_fields(cell: dict) -> dict:
    """The reference's configuration: the file's `model` mapping with the
    cell's latent resolution."""
    cfg = dict(cell["config_file"]["model"])
    cfg["img_resolution"] = cell["image_size"] // 8
    return cfg


def process_seconds() -> float:
    """Seconds since this process started (its start time in /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


SETUP = []   # (phase, seconds since the process started), as passed


def mark(phase: str):
    """Note that set-up has passed `phase`: the run prints how long each
    phase took."""
    SETUP.append((phase, process_seconds()))


class WindowClosed(Exception):
    """Raised from inside a timed loop at the first call past the
    window's length."""


class Window:
    """Counts whole calls from the first to the synchronise after the
    last: `tick()` before each call raises `WindowClosed` once `seconds`
    have passed on the host clock since `start()`; the calls made before
    that are all the work, and `stop(sync)` ends the time after they
    finished."""

    def __init__(self, seconds: float, limit_calls: Optional[int] = None):
        self.seconds = seconds
        self.limit_calls = limit_calls
        self.calls = 0
        self.t0 = self.wall = None

    def start(self):
        self.t0 = time.perf_counter()

    def tick(self):
        if (time.perf_counter() - self.t0 >= self.seconds
                or (self.limit_calls is not None
                    and self.calls >= self.limit_calls)):
            raise WindowClosed
        self.calls += 1

    def stop(self, sync):
        sync()
        self.wall = time.perf_counter() - self.t0
        return self.wall


@dataclasses.dataclass
class Check:
    """One number compared with its limit: correct while value <= limit
    (a value that is not finite is not correct)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit

    def as_dict(self):
        return {"value": self.value, "limit": self.limit}


@dataclasses.dataclass
class Ctx:
    """What a run hands to the metric readers (`metrics/<name>.py`): the
    cell, the timed window, the traced window and the spans and counters
    the benchmark recorded around its calls into the port."""
    cell: dict
    setup_s: float = 0.0
    window_s: float = 0.0          # the timed window, host clock
    calls: int = 0                 # drift calls or train steps in it
    images_per_call: float = 0.0   # images a call completes
    flops_per_call: float = 0.0    # model FLOPs of one call
    peak_flops: float = 989e12     # bf16 dense tensor-core peak
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    trace: Any = None              # trace.Trace of the profiled window
    bounds: Dict[str, float] = dataclasses.field(default_factory=dict)
