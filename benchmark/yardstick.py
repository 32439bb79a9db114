"""The benchmark's fixed measures: the card's published peaks and the
operations and bytes of the Riccati pass (K4).

`riccati_flops` and `riccati_bytes` are copied from chip_smoke.py lines
370-392, unchanged. The peaks are NVIDIA's H100 SXM data sheet's dense
rates at the 700 W limit, as the port's PERF.md states them.
"""
from __future__ import annotations

PEAK_FP32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_HBM_BYTES_S = 3.35e12  # HBM3


def riccati_flops(N, nx, nu, n_bumps):
    """Floating-point operations that the Riccati pass needs, per step: Qx,
    Qu; AᵀVxx and BᵀVxx; one triangle of the symmetric Qxx and Quu + λI and
    all of Qxu; the Cholesky (again, with the bump, at the n_bumps steps where
    it fires); the forward and back substitution of the nx+1 right-hand
    sides; W = Quu·[K | k] + [Qxuᵀ | Qu]; Vx = Qx + KᵀW_k + Qxu k; and one
    triangle of the symmetric Vxx = Qxx + KᵀW_K + Qxu K. The
    symmetrization is not counted: one triangle needs none."""
    tri = lambda n: n * (n + 1) // 2
    chol = sum((nu - k) + 1 + (nu - k - 1) * (nu - k) for k in range(nu))
    per_t = (2 * nx * nx + 2 * nx * nu  # Qx, Qu
             + 2 * nx ** 3 + 2 * nu * nx * nx  # AᵀVxx, BᵀVxx
             + 2 * nx * tri(nx) + 2 * nx * nx * nu + 2 * nx * tri(nu) + nu  # Qxx, Qxu, Quu + λI
             + chol
             + (nx + 1) * 2 * nu * nu  # forward and back substitution
             + 2 * nu * nu * (nx + 1)  # W
             + 4 * nu * nx + 4 * nu * tri(nx))  # Vx, Vxx
    return N * per_t + n_bumps * (nu + chol)


def riccati_bytes(N, nx, nu):
    """Inputs read once (A, B, lx, lu, lxx, luu, λ), outputs written once."""
    return 4 * (N * nx * nx + N * nx * nu + (N + 1) * nx + N * nu + (N + 1) * nx * nx
                + N * nu * nu + 1 + N * nu * nx + N * nu)


def riccati_bound_s(N, nx, nu, batch):
    """The least time one launch over `batch` instances could take on the
    card: the larger of its operations over the float32 peak and its bytes
    over the memory bandwidth (no bump counted: the work these inputs need)."""
    return max(batch * riccati_flops(N, nx, nu, 0) / PEAK_FP32_FLOPS,
               batch * riccati_bytes(N, nx, nu) / PEAK_HBM_BYTES_S)
