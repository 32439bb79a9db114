"""ctypes bindings for the native I/O runtime (the repo's native/csvio.cpp).

An mmap'd CSV float parser and a background-thread telemetry writer that
never blocks the control loop, as in the JAX package's `io/native.py`.

The library is built from native/csvio.cpp with g++ at first use, into
`build/native/<hash of source and flags>/libmpcio.so` (once per hash, under a
file lock, so that two processes starting together build it once); nothing
is written into native/. Without a compiler every entry point falls back to
pure Python: `np.loadtxt` for reading, and the same `%.9g` rows written
synchronously. `available()` and `AsyncTelemetry.native` say which is in use.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from mpc_ilqr_tpu_torch.ops._build import digest

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "csvio.cpp")
BUILD_ROOT = os.path.join(_REPO, "build", "native")
CXXFLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None
_tried = False
build_error: Optional[str] = None  # why the native library is not in use, if it is not


def build() -> str:
    """Compile SOURCE (unless this exact build exists under BUILD_ROOT);
    return the library's path. Raises on a failed build."""
    out_dir = os.path.join(BUILD_ROOT, digest([SOURCE], CXXFLAGS))
    lib_path = os.path.join(out_dir, "libmpcio.so")
    if os.path.isfile(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)  # released on close, or when the process dies
        if not os.path.isfile(lib_path):
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            proc = subprocess.run(["g++", *CXXFLAGS, SOURCE, "-o", tmp], capture_output=True,
                                  text=True, timeout=120)
            if proc.returncode:
                raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
            os.replace(tmp, lib_path)
    return lib_path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(build())
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            build_error = f"{type(e).__name__}: {e}"
            return None
        lib.csv_read_matrix.restype = ctypes.POINTER(ctypes.c_double)
        lib.csv_read_matrix.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.csv_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
        lib.telemetry_open.restype = ctypes.c_void_p
        lib.telemetry_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.telemetry_log.restype = ctypes.c_int
        lib.telemetry_log.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ]
        lib.telemetry_dropped.restype = ctypes.c_int64
        lib.telemetry_dropped.argtypes = [ctypes.c_void_p]
        lib.telemetry_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library is built and loaded."""
    return _load() is not None


def read_csv_matrix(path: str, skip_rows: int = 0) -> np.ndarray:
    """CSV float matrix (rows, cols) in float64; numpy fallback without the
    native library."""
    lib = _load()
    if lib is None:
        return np.atleast_2d(
            np.loadtxt(path, delimiter=",", skiprows=skip_rows, dtype=np.float64))
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    ptr = lib.csv_read_matrix(path.encode(), skip_rows, ctypes.byref(rows), ctypes.byref(cols))
    if not ptr:
        raise IOError(f"native CSV parse failed for {path}")
    try:
        return np.ctypeslib.as_array(ptr, shape=(rows.value, cols.value)).copy()
    finally:
        lib.csv_free(ptr)


class AsyncTelemetry:
    """CSV writer: rows go to the native background thread (never blocking),
    or are written synchronously by Python without the native library.
    `close` drains the queue and joins the writer thread."""

    def __init__(self, path: str, header: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lib = _load()
        self._h = self._f = None
        self._dropped = 0
        if self._lib is not None:
            self._h = self._lib.telemetry_open(path.encode(), header.encode())
            if not self._h:
                raise IOError(f"telemetry_open failed for {path}")
        else:
            self._f = open(path, "w")
            self._f.write(header + "\n")
        self.native = self._lib is not None

    def log(self, row: np.ndarray) -> None:
        row = np.ascontiguousarray(row, dtype=np.float64)
        if self._h is not None:
            self._lib.telemetry_log(
                self._h, row.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), row.size)
        else:
            self._f.write(",".join(f"{v:.9g}" for v in row) + "\n")

    @property
    def dropped(self) -> int:
        """Rows the native queue refused; after close, the final count."""
        if self._h is not None:
            return int(self._lib.telemetry_dropped(self._h))
        return self._dropped

    def close(self) -> None:
        if self._h is not None:
            self._dropped = int(self._lib.telemetry_dropped(self._h))
            self._lib.telemetry_close(self._h)
            self._h = None
        elif self._f is not None:
            self._f.close()
            self._f = None
