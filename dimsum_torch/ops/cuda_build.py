"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `dimsum_torch/csrc/<name>.cu` has a plain C interface and becomes
`build/dimsum_torch/<name>-<hash>.so` at the root of the checkout, built at
first use for sm_90a.  The hash covers the source, so an edited source is
rebuilt and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dimsum_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("selective_scan_fwd", "selective_scan_fwd_train",
           "selective_scan_bwd")


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
    raises if any build fails."""
    started = {n: _start_build(n) for n in names}
    logs, failed = {}, []
    for name, job in started.items():
        if job is None:
            logs[name] = ""
            continue
        proc, tmp, out = job
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
