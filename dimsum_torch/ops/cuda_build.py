"""Build the port's CUDA sources with nvcc, load them with ctypes, and call
their entry points.

Each `dimsum_torch/csrc/<name>.cu` has a plain C interface, an entry point
`dimsum_<name>` (a source may add others, `dimsum_<name>_<entry>`) that
takes the stream last and returns a cudaError_t, and becomes
`build/dimsum_torch/<name>-<hash>.so` at the root of the checkout, built at
first use for sm_90a.  The hash covers the source, so an edited
source is rebuilt and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dimsum_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("selective_scan_fwd", "selective_scan_fwd_train",
           "selective_scan_bwd", "full_attention", "full_attention_sm90",
           "full_attention_f32", "add_norm", "norm_modulate", "conv_xproj")
# the entry points' dtype argument
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                           "build the port's kernels")
    return found


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{tag}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path),
    or None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Build every named source, one nvcc each, all started together.
    Returns each source's compiler output ("" when it was already built);
    raises if any build fails.  `build.seconds` holds each source's
    seconds from the start to its nvcc's exit (the last build's)."""
    t0 = time.monotonic()
    started = {n: _start_build(n) for n in names}
    logs, failed = {n: "" for n, job in started.items() if job is None}, []
    build.seconds = {}

    def finish(name, proc, tmp, out):
        logs[name], _ = proc.communicate()
        build.seconds[name] = time.monotonic() - t0
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)

    waits = [threading.Thread(target=finish, args=(name, *job))
             for name, job in started.items() if job is not None]
    for w in waits:
        w.start()
    for w in waits:
        w.join()
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


@functools.lru_cache(maxsize=None)
def _entry(name: str, argtypes: tuple, symbol: str):
    fn = getattr(load(name), symbol)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, argtypes: Sequence, device, *args,
           entry: str | None = None) -> None:
    """Call `dimsum_<name>` of source `name` (built first if needed), or
    its entry `dimsum_<name>_<entry>`, with `args`, whose ctypes are
    `argtypes` (a tensor, or None, goes as its pointer), on `device`'s
    current stream; raise if it returns a CUDA error."""
    symbol = f"dimsum_{name}" + (f"_{entry}" if entry else "")
    fn = _entry(name, tuple(argtypes), symbol)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args], stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")


def needs_grad(*tensors) -> bool:
    """Grad mode is on and one of `tensors` (None allowed) requires grad:
    a kernel wrapper without a backward must not run then."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def check_tensor(name: str, t, device, dtype, shape) -> None:
    """Raise unless `t` is a contiguous tensor of `dtype` and `shape` on
    `device`: what a kernel wrapper checks before passing a pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
