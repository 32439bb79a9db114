"""Build and bind the CUDA rollout kernels (csrc/*.cu) at first use.

One `nvcc` call compiles the sources into a shared library with a plain C
interface under `build/torch_kernels/<hash of sources and flags>/`, loaded
with ctypes. The finished library is renamed into place, so a cut build
leaves nothing that a later one would wait on. A failed build raises with
nvcc's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_log = {"seconds": None, "ptxas": [], "path": None}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    names = sorted(os.listdir(CSRC))
    return ([os.path.join(CSRC, n) for n in names if n.endswith(".cu")],
            [os.path.join(CSRC, n) for n in names if n.endswith((".cu", ".cuh"))])


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(ARCH + CFLAGS).encode())
    for f in files:
        h.update(os.path.basename(f).encode())
        with open(f, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile csrc/*.cu (unless this exact build exists) and return the path
    of the shared library."""
    cu, files = _sources()
    out_dir = os.path.join(BUILD_ROOT, _digest(files))
    lib_path = os.path.join(out_dir, "libmpc_rollout.so")
    if os.path.isfile(lib_path):
        build_log.update(seconds=0.0, path=lib_path)
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *ARCH, *CFLAGS, "-shared", "-I", CSRC, "-o", tmp, *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          timeout=600)
    if proc.returncode:
        raise RuntimeError(f"CUDA kernel build failed: {' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, lib_path)
    build_log.update(seconds=time.perf_counter() - t0, path=lib_path,
                     ptxas=[ln for ln in proc.stdout.splitlines() if "ptxas" in ln])
    return lib_path


def library() -> ctypes.CDLL:
    """The bound kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        model = [P, P, I, I, I, I, I, I, I]  # fbuf, ibuf, n_float, n_int, B, nq, nv, nu, ncp
        lib.mpc_rollout_open.argtypes = model + [P, P, P, I, I, F, P]
        lib.mpc_rollout_open.restype = I
        lib.mpc_rollout_feedback.argtypes = model + [P, P, P, P, P, P, I, P, P, I, I, F, P]
        lib.mpc_rollout_feedback.restype = I
        lib.mpc_error_string.argtypes = [I]
        lib.mpc_error_string.restype = ctypes.c_char_p
        lib.mpc_smem_bytes.argtypes = [I, I, I, I, I, I, I]
        lib.mpc_smem_bytes.restype = LL
        _lib = lib
        return lib
