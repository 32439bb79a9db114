"""The Riccati backward pass in one launch, its plain version and its launch
count.

    backward_pass_kernel   K4, TPU backward_pass_pallas (mpc_ilqr_tpu/ops/riccati.py:143)

On CUDA tensors the entry point launches `riccati_backward`
(csrc/riccati.cu) on the current stream, checks the launch, counts it in
LAUNCHES and never synchronises; λ goes to the kernel as a one-element device
tensor, so no backward pass reads it on the host. It raises on anything the
kernel does not take: float32 only, as on the TPU, contiguous, one device,
nx ≤ MAX_NX, nu ≤ MAX_NU. On CPU tensors it runs `backward_pass_plain`, the
kernel's own algorithm step by step in any float dtype. The TPU kernel's
padding to multiples of 8 and its masked-matvec pivot access were Mosaic
constraints and are not kept.
"""
from __future__ import annotations

import torch

from mpc_ilqr_tpu_torch.ops import _build

MAX_NX, MAX_NU = 64, 32  # csrc/riccati.cu kMaxNx, kMaxNu
LAUNCHES = {"riccati": 0}
CUDA_KERNEL = {"riccati": "riccati_backward"}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---- plain version ------------------------------------------------------------

def _cholesky(S):
    """Right-looking Cholesky, one pivot at a time (the TPU kernel's
    _chol_masked). A non-positive pivot gives rsqrt's NaN or inf, which
    propagates."""
    n = S.shape[0]
    S, L = S.clone(), torch.zeros_like(S)
    for k in range(n):
        lk = S[k:, k] * torch.rsqrt(S[k, k])
        L[k:, k] = lk
        S[k:, k:] -= torch.outer(lk, lk)
    return L


def _solve_cholesky(L, R):
    """X with L Lᵀ X = R: forward, then back substitution, row by row
    (the TPU kernel's _solve_chol)."""
    n = L.shape[0]
    Y = torch.zeros_like(R)
    for k in range(n):
        Y[k] = (R[k] - L[k, :k] @ Y[:k]) / L[k, k]
    X = torch.zeros_like(R)
    for k in reversed(range(n)):
        X[k] = (Y[k] - L[k + 1:, k] @ X[k + 1:]) / L[k, k]
    return X


def backward_pass_plain(A, B, lx, lu, lxx, luu, reg, pd_bump: float, bumps: list | None = None):
    """K (N, nu, nx), kff (N, nu) by the kernel's algorithm (ilqr.cpp:250-309):
    at t = N-1 .. 0 form the Q terms, factor Quu + λI, add pd_bump·I and
    factor again when the first factor has a non-finite entry, solve for
    [K | k], update and symmetrize the value function. Given a list as
    `bumps`, appends to it each t where the bump fired (one host read per
    step)."""
    N, nx, nu = A.shape[0], A.shape[1], B.shape[-1]
    dt, dev = A.dtype, A.device
    I_u = torch.eye(nu, dtype=dt, device=dev)
    reg = torch.as_tensor(reg, dtype=dt, device=dev)
    Vx, Vxx = lx[N], lxx[N]
    K_out = torch.empty((N, nu, nx), dtype=dt, device=dev)
    k_out = torch.empty((N, nu), dtype=dt, device=dev)
    for t in reversed(range(N)):
        At, Bt = A[t].T, B[t].T
        Qx = lx[t] + At @ Vx
        Qu = lu[t] + Bt @ Vx
        AtV, BtV = At @ Vxx, Bt @ Vxx
        Qxx = lxx[t] + AtV @ A[t]
        Qxu = AtV @ B[t]
        Quu = luu[t] + BtV @ B[t] + reg * I_u
        bad = ~torch.isfinite(_cholesky(Quu)).all()
        if bumps is not None and bool(bad):
            bumps.append(t)
        Quu = Quu + bad.to(dt) * pd_bump * I_u
        L = _cholesky(Quu)
        X = -_solve_cholesky(L, torch.cat([Qxu.T, Qu[:, None]], dim=1))
        K_t, k_t = X[:, :nx], X[:, nx]
        KT = K_t.T
        Vx = Qx + KT @ (Quu @ k_t + Qu) + Qxu @ k_t
        Vxx = Qxx + KT @ (Quu @ K_t) + KT @ Qxu.T + Qxu @ K_t
        Vxx = 0.5 * (Vxx + Vxx.T)
        K_out[t], k_out[t] = K_t, k_t
    return K_out, k_out


# ---- kernel -------------------------------------------------------------------

def _on_card(tensors, shapes) -> bool:
    """True for CUDA inputs (checked for the kernel), False for CPU inputs;
    raises on shapes that do not fit and on anything else."""
    for t, shape in zip(tensors, shapes):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"Riccati input shape {tuple(t.shape)}, expected {shape}")
    dev = tensors[0].device
    if all(t.device.type == "cpu" for t in tensors):
        return False
    if dev.type != "cuda":
        raise ValueError(f"the Riccati kernel takes CUDA tensors or CPU tensors, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"the Riccati kernel takes contiguous float32 tensors on one CUDA "
                             f"device, got {t.dtype} {t.device} contiguous={t.is_contiguous()}")
    nx, nu = shapes[1][1], shapes[1][2]
    if nx > MAX_NX or nu > MAX_NU:
        raise ValueError(f"the Riccati kernel takes nx <= {MAX_NX} and nu <= {MAX_NU}, "
                         f"got nx={nx}, nu={nu}")
    return True


def backward_pass_kernel(A, B, lx, lu, lxx, luu, reg, pd_bump: float):
    """K4 — the whole backward pass in one launch: K (N, nu, nx), kff (N, nu)
    from A (N, nx, nx), B (N, nx, nu), lx (N+1, nx), lu (N, nu),
    lxx (N+1, nx, nx), luu (N, nu, nu) and λ (a scalar or 0-dim tensor)."""
    N, nx, nu = A.shape[0], A.shape[-1], B.shape[-1]
    args = (A, B, lx, lu, lxx, luu)
    shapes = [(N, nx, nx), (N, nx, nu), (N + 1, nx), (N, nu), (N + 1, nx, nx), (N, nu, nu)]
    if N < 1:
        raise ValueError("the Riccati backward pass needs N >= 1")
    if not _on_card(args, shapes):
        return backward_pass_plain(*args, reg, pd_bump)
    dev = A.device
    reg_d = torch.as_tensor(reg, dtype=torch.float32, device=dev).reshape(1).contiguous()
    lib = _build.library()
    K = torch.empty((N, nu, nx), dtype=torch.float32, device=dev)
    kff = torch.empty((N, nu), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.mpc_riccati_backward(*(t.data_ptr() for t in args), reg_d.data_ptr(),
                                  float(pd_bump), K.data_ptr(), kff.data_ptr(), N, nx, nu, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel riccati_backward failed to launch: "
                           f"{lib.mpc_error_string(rc).decode()} (error {rc})")
    LAUNCHES["riccati"] += 1
    return K, kff
