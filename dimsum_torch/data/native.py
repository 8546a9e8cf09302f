"""ctypes bindings for the port's native batch gather, port of
`dimsum_tpu/data/native.py`: rows of an mmap'd fp32 latent store gathered
into one contiguous batch by C++ threads that do not hold the GIL
(`dimsum_torch/native/batch_gather.cpp`, the port's own copy of the JAX
package's source).

The source is built with g++ at first use into `build/dimsum_torch/` at
the root of the checkout, as `batch_gather-<hash>.so`, the hash covering
the source and the flags (as `ops/cuda_build.py` keys the CUDA sources), so
an edited source is rebuilt and a stale library is never loaded.

The JAX store falls back to numpy without a word when the build fails
(native.py:57-58, :76-80).  Here the native route is the default and a
failed build raises; the numpy route runs only when the caller asks for it
(`native=False`), and `is_native` says which route a store takes.  Both
give the same bytes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "batch_gather.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dimsum_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def library_path() -> Path:
    tag = hashlib.sha1(SOURCE.read_bytes()
                       + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"batch_gather-{tag}.so"


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built gather library, built first if needed (by g++, into a
    temporary file renamed into place, so that concurrent builders never
    load half a library).  Raises if g++ fails."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed to build {SOURCE}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.bg_open.restype = ctypes.c_void_p
    lib.bg_open.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.bg_num_rows.restype = ctypes.c_int64
    lib.bg_num_rows.argtypes = [ctypes.c_void_p]
    lib.bg_gather.restype = ctypes.c_int
    lib.bg_gather.argtypes = [ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                              ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    lib.bg_close.restype = None
    lib.bg_close.argtypes = [ctypes.c_void_p]
    return lib


class NativeLatentStore:
    """Row store over a fp32 file of (N, *sample_shape) rows:

        store = NativeLatentStore(path, (4, 32, 32))
        batch = store.gather(indices)        # (n, 4, 32, 32) fp32

    `native=True` (the default) gathers with the C++ threads and raises if
    the library cannot be built or the file cannot be mapped; `native=False`
    gathers by numpy fancy indexing of a memmap."""

    def __init__(self, path: str, sample_shape, num_threads: int = 8,
                 native: bool = True):
        self._lib = self._handle = self._mm = None
        self.sample_shape = tuple(int(s) for s in sample_shape)
        self.row_floats = int(np.prod(self.sample_shape))
        self.row_bytes = 4 * self.row_floats
        self.num_threads = num_threads
        if native:
            self._lib = load()
            handle = self._lib.bg_open(os.fsencode(path), self.row_bytes)
            if not handle:
                raise OSError(f"batch gather cannot map {path}")
            self._handle = handle
            self.num_rows = int(self._lib.bg_num_rows(handle))
        else:
            mm = np.memmap(path, dtype=np.float32, mode="r")
            self.num_rows = mm.size // self.row_floats
            self._mm = mm[: self.num_rows * self.row_floats].reshape(
                self.num_rows, self.row_floats)

    @property
    def is_native(self) -> bool:
        return self._lib is not None

    def __len__(self):
        return self.num_rows

    def gather(self, indices) -> np.ndarray:
        idx = np.ascontiguousarray(indices, np.int64)
        n = len(idx)
        out = np.empty((n, self.row_floats), np.float32)
        if self._lib is not None:
            if self._handle is None:
                raise ValueError("gather on a closed store")
            # a thread costs ~100 us to start: fan out for multi-MB batches
            nthreads = min(self.num_threads,
                           max(1, (n * self.row_bytes) >> 23))
            rc = self._lib.bg_gather(
                self._handle, idx.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_int64)), n,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), nthreads)
            if rc != 0:
                raise IndexError(f"batch gather: an index outside "
                                 f"[0, {self.num_rows})")
        else:
            out[:] = self._mm[idx]
        return out.reshape(n, *self.sample_shape)

    def close(self):
        if self._handle is not None:
            self._lib.bg_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
