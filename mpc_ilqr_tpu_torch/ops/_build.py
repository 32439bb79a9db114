"""Build and bind the CUDA kernels (csrc/*.cu) at first use.

One `nvcc` per source, all started together, compiles the sources to
objects, and one more links them into a shared library with a plain C
interface under `build/torch_kernels/<hash of toolchain, sources and
flags>/`, loaded with ctypes. The hash takes `nvcc --version` whole (its
first line names only the compiler; the release and build lines pin the
toolchain) and the flags pin the target (sm_90a), so another compiler or
another target builds anew: the port's counterpart of the reference's
compile persistence (mpc_ilqr_tpu/utils/aot.py), whose fingerprint pins
the toolchain and the device kind. The finished library is renamed into
place, so a cut build leaves nothing that a later one would wait on. A failed build raises with
nvcc's output. `build` also takes another csrc/ directory and build root,
so that an earlier design of the kernels can be built beside the current
one (tools/port_rollout_designs.py).
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
_toolchain = None
build_log = {"seconds": None, "ptxas": [], "path": None}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources(csrc):
    names = sorted(os.listdir(csrc))
    return ([os.path.join(csrc, n) for n in names if n.endswith(".cu")],
            [os.path.join(csrc, n) for n in names if n.endswith((".cu", ".cuh"))])


def toolchain() -> str:
    """`nvcc --version`'s output (cached)."""
    global _toolchain
    if _toolchain is None:
        proc = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True, timeout=60)
        if proc.returncode:
            raise RuntimeError(f"nvcc --version failed:\n{proc.stdout}{proc.stderr}")
        _toolchain = proc.stdout
    return _toolchain


def digest(files, flags=tuple(ARCH + CFLAGS), tool: str = "") -> str:
    """Hash of the toolchain's version text, the flags and the sources'
    names and bytes: a build's directory."""
    h = hashlib.sha256(tool.encode())
    h.update(" ".join(flags).encode())
    for f in files:
        h.update(os.path.basename(f).encode())
        with open(f, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def build(csrc: str = CSRC, root: str = BUILD_ROOT) -> str:
    """Compile csrc/*.cu (unless this exact build exists under root) and
    return the path of the shared library."""
    cu, files = _sources(csrc)
    out_dir = os.path.join(root, digest(files, tool=toolchain()))
    lib_path = os.path.join(out_dir, "libmpc_kernels.so")
    if os.path.isfile(lib_path):
        build_log.update(seconds=0.0, path=lib_path)
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in cu:
        obj = os.path.join(out_dir, f"{os.path.basename(src)}.{tag}.o")
        cmd = [_nvcc(), *ARCH, *CFLAGS, "-c", "-I", csrc, "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    logs = [proc.communicate(timeout=600)[0] for _, _, proc in jobs]  # wait for all
    for (cmd, _, proc), out in zip(jobs, logs):
        if proc.returncode:
            raise RuntimeError(f"CUDA kernel build failed: {' '.join(cmd)}\n{out}")
    tmp = f"{lib_path}.{tag}"
    cmd = [_nvcc(), *ARCH, "-shared", "-o", tmp, *(obj for _, obj, _ in jobs)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          timeout=600)
    if proc.returncode:
        raise RuntimeError(f"CUDA kernel link failed: {' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, lib_path)
    for _, obj, _ in jobs:
        os.remove(obj)
    build_log.update(seconds=time.perf_counter() - t0, path=lib_path,
                     ptxas=[ln for out in logs for ln in out.splitlines()
                            if "ptxas" in ln or "spill" in ln])
    return lib_path


def bind(lib_path: str) -> ctypes.CDLL:
    """Load a built library and declare its C interface."""
    lib = ctypes.CDLL(lib_path)
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
    # A, B, lx, lu, lxx, luu, reg, pd_bump, K, kff, N, nx, nu, stream
    lib.mpc_riccati_backward.argtypes = [P] * 7 + [F, P, P, I, I, I, P]
    lib.mpc_riccati_backward.restype = I
    lib.mpc_riccati_smem_bytes.argtypes = [I, I]
    lib.mpc_riccati_smem_bytes.restype = LL
    if hasattr(lib, "mpc_riccati_backward_batched"):  # an earlier design's library lacks it
        # A, B, lx, lu, lxx, luu, reg, pd_bump, K, kff, scratch, batch, N, nx, nu, stream
        lib.mpc_riccati_backward_batched.argtypes = [P] * 7 + [F, P, P, P, I, I, I, I, P]
        lib.mpc_riccati_backward_batched.restype = I
        lib.mpc_riccati_scratch_floats.argtypes = [I, I]
        lib.mpc_riccati_scratch_floats.restype = LL
    if hasattr(lib, "mpc_riccati_cluster"):  # the cluster design
        lib.mpc_riccati_cluster.argtypes = [I, I]
        lib.mpc_riccati_cluster.restype = I
        lib.mpc_riccati_active_clusters.argtypes = [I, I]
        lib.mpc_riccati_active_clusters.restype = I
        # A, B, lx, lu, lxx, luu, reg, pd_bump, K, kff, ldx, ldu, batch, N, nx, nu, stream
        lib.mpc_riccati_backward_wide.argtypes = [P] * 7 + [F, P, P] + [I] * 6 + [P]
        lib.mpc_riccati_backward_wide.restype = I
    return lib


def library() -> ctypes.CDLL:
    """The bound kernel library of csrc/ (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(build())
        return _lib
