#!/usr/bin/env python3
"""Where a knot's time goes in K4's wide design (riccati_backward_wide), on
one GPU: clock64 cycles per knot and phase, read by thread 0 of the first
CTA of the first cluster.

    python3 tools/port_riccati_phases.py [--cluster C] [--n 100] [--csrc DIR]

Copies the package's csrc/ (or DIR, a variant of it) under
logs/riccati_phases/, defines the kernel's RICCATI_STAMP hooks there (each
adds the cycles since the previous stamp to a __device__ counter with one
atomicAdd, so the stamping thread never waits on memory) and, with
--cluster, RICCATI_FORCE_CLUSTER (C CTAs per instance in place of the
op's own choice; C=2 against the op's 4 at the hands sizes is what set
kMinCluster), builds that copy with ops/_build.build and runs it on
chip_smoke's hands inputs (H1 with hands, nx=103, nu=45; N=100 at dt 0.01
unless --n 25), padded as the op pads them, through the kernel's C entry
point: once to warm up, once counted, then five timed; prints the kernel's
registers and spills (ptxas) first. One cluster size per process: two
builds of the same kernels in one process are not safe. A barrier's line
is the time thread 0 waits there, so the slowest CTA's work shows up in
it. Prints cycles per knot for each phase, their sum, the ms of the
counted launch and per timed launch (CUDA events) and nvidia-smi's name,
clocks and power limit.
"""
import argparse
import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
WORK = os.path.join(ROOT, "logs", "riccati_phases")
N_STAMPS = 19
PHASES = ("knot setup", "1 W, Y tiles", "barrier 1", "push W + barrier 2", "2a Qxx tiles",
          "barrier 3", "push Y + barrier 4", "2b R, Quu tiles", "barrier 5",
          "push Quu + barrier 6", "3 factor + forward substitution", "3 back substitution",
          "3 gains, P tiles", "barrier 7", "push X, R + barrier 8", "4 T tiles", "barrier 9",
          "push T + barrier 10", "symmetrize")
PROBE = f"""// probe build (tools/port_riccati_phases.py)
#include <cuda_runtime.h>
__device__ unsigned long long mpc_probe_cycles[{N_STAMPS}];
#define RICCATI_STAMP_START unsigned long long probe_t_ = clock64();
#define RICCATI_STAMP(i)                                                    \\
  do {{                                                                     \\
    if (blockIdx.x == 0 && threadIdx.x == 0) {{                              \\
      const unsigned long long n_ = clock64();                              \\
      atomicAdd(&mpc_probe_cycles[i], n_ - probe_t_);                       \\
      probe_t_ = n_;                                                        \\
    }}                                                                      \\
  }} while (0)
extern "C" int mpc_probe_read(unsigned long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, mpc_probe_cycles, sizeof(mpc_probe_cycles));
}}
extern "C" int mpc_probe_reset() {{
  static const unsigned long long zero[{N_STAMPS}] = {{}};
  return (int)cudaMemcpyToSymbol(mpc_probe_cycles, zero, sizeof(zero));
}}
"""


def probe_library(csrc, cluster):
    from mpc_ilqr_tpu_torch.ops import _build

    src = os.path.join(WORK, "csrc")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(csrc or _build.CSRC, src)
    path = os.path.join(src, "riccati.cu")
    with open(path) as fh:
        body = fh.read()
    with open(path, "w") as fh:
        force = f"#define RICCATI_FORCE_CLUSTER {cluster}\n" if cluster else ""
        fh.write(PROBE + force + body)
    lib = _build.bind(_build.build(src, os.path.join(WORK, "build")))
    lib.mpc_probe_read.argtypes = [ctypes.c_void_p]
    lib.mpc_probe_read.restype = ctypes.c_int
    lib.mpc_probe_reset.restype = ctypes.c_int
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cluster", type=int, choices=(2, 4, 8),
                    help="CTAs per instance (default: the op's own choice)")
    ap.add_argument("--n", type=int, default=100, choices=(25, 100))
    ap.add_argument("--csrc", help="another csrc/ directory (default: the package's)")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs

    lib = probe_library(args.csrc, args.cluster)
    from mpc_ilqr_tpu_torch.ops import _build, riccati

    pl = _build.build_log["ptxas"]
    for i, ln in enumerate(pl):
        if "riccati_backward_wide" in ln and "Compiling" in ln:
            print("\n".join(pl[i + 1:i + 3]))
    li = cs.hands_inputs(args.n, dict(cs.HANDS_SIZES)[args.n])
    a, cfg = li["args"], li["prob"].cfg
    N = a[0].shape[0]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    nx, nu = a[0].shape[1], a[1].shape[2]
    C = lib.mpc_riccati_cluster(nx, nu)
    padded, ldx, ldu = riccati.pad_rows(*a)
    K, kff = torch.empty((N, nu, nx), device="cuda"), torch.empty((N, nu), device="cuda")
    reg = torch.tensor([cfg.reg_init], dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = lib.mpc_riccati_backward_wide(*(t.data_ptr() for t in padded), reg.data_ptr(),
                                           cfg.pd_bump, K.data_ptr(), kff.data_ptr(), ldx, ldu,
                                           1, N, nx, nu, stream)
        if rc != 0:
            raise RuntimeError(f"riccati_backward_wide on {C} CTAs: "
                               f"{lib.mpc_error_string(rc).decode()}")

    call()
    torch.cuda.synchronize()
    assert lib.mpc_probe_reset() == 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    call()
    end.record()
    torch.cuda.synchronize()
    out = np.zeros(N_STAMPS, dtype=np.uint64)
    assert lib.mpc_probe_read(out.ctypes.data) == 0
    per = out.astype(np.float64) / N
    ms = cs.event_ms(call, 5)
    print(f"hands N={N}, {C} CTAs per instance: {start.elapsed_time(end):.4f} ms for the "
          f"counted launch, {ms:.4f} ms per launch over 5 more; cycles per knot (thread 0 of "
          f"CTA 0), {per.sum():.0f} in all:")
    for name, c in zip(PHASES, per):
        print(f"  {name:40s} {c:9.0f}  {100 * c / per.sum():5.1f}%")
    print(smi)


if __name__ == "__main__":
    main()
