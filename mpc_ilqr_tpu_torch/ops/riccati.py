"""The Riccati backward pass in one launch, its plain version and its launch
count.

    backward_pass_kernel   K4, TPU backward_pass_pallas (mpc_ilqr_tpu/ops/riccati.py:143)

K4 is the custom op `mpc_ilqr_tpu_torch::riccati_backward` over a leading
batch of instances, with a `torch.func.vmap` rule, so that a vmapped solve
(solve_batched, the fleet) runs it as one launch with one block (or one
thread-block cluster) per instance, each with its own λ: the counterpart of
the grid step per instance that vmap gives the Pallas kernel. On CUDA
tensors the op launches `riccati_backward` or, where the C side's
`mpc_riccati_cluster` names a cluster (above nx = 64 or nu = 32),
`riccati_backward_wide` (csrc/riccati.cu: a cluster of CTAs per instance,
no global scratch; `pad_rows` first pads the rows to multiples of 4 floats
so that each knot comes in by tensor copies) on the current stream, checks
the launch, counts it in
LAUNCHES and never synchronises; λ goes to the kernel as a device tensor,
so no backward pass reads it on the host. It raises on anything the kernel
does not take: float32 only, as on the TPU, contiguous, one device,
nx ≤ MAX_NX, nu ≤ MAX_NU. On CPU tensors it runs `backward_pass_plain`, the
kernel's own algorithm step by step in any float dtype (vmapped over the
instances). The TPU kernel's padding to multiples of 8 and its
masked-matvec pivot access were Mosaic constraints and are not kept.
"""
from __future__ import annotations

import torch

from mpc_ilqr_tpu_torch.ops import _build

MAX_NX, MAX_NU = 160, 80  # csrc/riccati.cu kMaxNxW, kMaxNuW
LAUNCHES = {"riccati": 0}
LAST_LAUNCH = {"batch": 0, "N": 0, "nx": 0, "nu": 0}  # the shape of the last launch
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


def backward_pass_plain(A, B, lx, lu, lxx, luu, reg, pd_bump: float, with_bumps: bool = False):
    """K (N, nu, nx), kff (N, nu) by the kernel's algorithm (ilqr.cpp:250-309):
    at t = N-1 .. 0 form the Q terms, factor Quu + λI, add pd_bump·I and
    factor again when the first factor has a non-finite entry, solve for
    [K | k], update and symmetrize the value function. With `with_bumps`,
    also the steps where the bump fired, an (N,) bool tensor. No host read:
    it runs under torch.func.vmap."""
    N, nx, nu = A.shape[0], A.shape[1], B.shape[-1]
    dt, dev = A.dtype, A.device
    I_u = torch.eye(nu, dtype=dt, device=dev)
    reg = torch.as_tensor(reg, dtype=dt, device=dev)
    Vx, Vxx = lx[N], lxx[N]
    K_out, k_out, bumped = [None] * N, [None] * N, [None] * N
    for t in reversed(range(N)):
        At, Bt = A[t].T, B[t].T
        Qx = lx[t] + At @ Vx
        Qu = lu[t] + Bt @ Vx
        AtV, BtV = At @ Vxx, Bt @ Vxx
        Qxx = lxx[t] + AtV @ A[t]
        Qxu = AtV @ B[t]
        Quu = luu[t] + BtV @ B[t] + reg * I_u
        bad = bumped[t] = ~torch.isfinite(_cholesky(Quu)).all()
        Quu = Quu + bad.to(dt) * pd_bump * I_u
        L = _cholesky(Quu)
        X = -_solve_cholesky(L, torch.cat([Qxu.T, Qu[:, None]], dim=1))
        K_t, k_t = X[:, :nx], X[:, nx]
        KT = K_t.T
        Vx = Qx + KT @ (Quu @ k_t + Qu) + Qxu @ k_t
        Vxx = Qxx + KT @ (Quu @ K_t) + KT @ Qxu.T + Qxu @ K_t
        Vxx = 0.5 * (Vxx + Vxx.T)
        K_out[t], k_out[t] = K_t, k_t
    if with_bumps:
        return torch.stack(K_out), torch.stack(k_out), torch.stack(bumped)
    return torch.stack(K_out), torch.stack(k_out)


# ---- kernel -------------------------------------------------------------------

def _on_card(tensors, shapes) -> bool:
    """True for CUDA inputs (checked for the kernel), False for CPU inputs;
    raises on shapes that do not fit and on anything else. Contiguity is the
    op's to check: under vmap only the op sees the batch's layout."""
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
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"the Riccati kernel takes float32 tensors on one CUDA device, got "
                             f"{t.dtype} {t.device}")
    nx, nu = shapes[1][1], shapes[1][2]
    if nx > MAX_NX or nu > MAX_NU:
        raise ValueError(f"the Riccati kernel takes nx <= {MAX_NX} and nu <= {MAX_NU}, "
                         f"got nx={nx}, nu={nu}")
    return True


def _launch(A, B, lx, lu, lxx, luu, reg, pd_bump: float):
    """One launch over the batch (one block or cluster per instance) on CUDA
    tensors."""
    args = (A, B, lx, lu, lxx, luu, reg)
    for t in args:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"the Riccati kernel takes contiguous float32 tensors, got "
                             f"{t.dtype} contiguous={t.is_contiguous()}")
    n, N, nx, nu = A.shape[0], A.shape[1], A.shape[2], B.shape[-1]
    dev = A.device
    lib = _build.library()
    K = torch.empty((n, N, nu, nx), dtype=torch.float32, device=dev)
    kff = torch.empty((n, N, nu), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if lib.mpc_riccati_cluster(nx, nu):  # the wide design, on padded rows
        padded, ldx, ldu = pad_rows(A, B, lx, lu, lxx, luu)
        rc = lib.mpc_riccati_backward_wide(*(t.data_ptr() for t in padded), reg.data_ptr(),
                                           float(pd_bump), K.data_ptr(), kff.data_ptr(), ldx, ldu,
                                           n, N, nx, nu, stream)
    else:
        rc = lib.mpc_riccati_backward_batched(*(t.data_ptr() for t in args), float(pd_bump),
                                              K.data_ptr(), kff.data_ptr(), None, n, N, nx, nu,
                                              stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel riccati_backward failed to launch: "
                           f"{lib.mpc_error_string(rc).decode()} (error {rc})")
    LAUNCHES["riccati"] += 1
    LAST_LAUNCH.update(batch=n, N=N, nx=nx, nu=nu)
    return K, kff


def pad_rows(A, B, lx, lu, lxx, luu):
    """The wide design's inputs with every row padded by zeros to a multiple
    of 4 floats (ldx = round4(nx) for A, lxx, lx; ldu = round4(nu) for B,
    luu, lu), in new 16-byte aligned tensors, so that each knot comes into
    shared memory by tensor copies (a row of A at nx=103 is 412 bytes, and
    tensor copies take rows of multiples of 16 bytes at 16-byte aligned
    addresses; the kernel refuses other rows). One
    extra read and write of the inputs, ~13 MB at (N, nx, nu) = (100, 103, 45)."""
    nx, nu = A.shape[-1], B.shape[-1]
    ldx, ldu = -(-nx // 4) * 4, -(-nu // 4) * 4
    px = lambda t: torch.nn.functional.pad(t, (0, ldx - nx))
    pu = lambda t: torch.nn.functional.pad(t, (0, ldu - nu))
    return (px(A), pu(B), px(lx), pu(lu), px(lxx), pu(luu)), ldx, ldu


@torch.library.custom_op("mpc_ilqr_tpu_torch::riccati_backward", mutates_args=())
def riccati_backward(A: torch.Tensor, B: torch.Tensor, lx: torch.Tensor, lu: torch.Tensor,
                     lxx: torch.Tensor, luu: torch.Tensor, reg: torch.Tensor,
                     pd_bump: float) -> tuple[torch.Tensor, torch.Tensor]:
    """K (n, N, nu, nx), kff (n, N, nu) for n instances: A (n, N, nx, nx),
    B (n, N, nx, nu), lx (n, N+1, nx), lu (n, N, nu), lxx (n, N+1, nx, nx),
    luu (n, N, nu, nu), λ (n,). The kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if A.device.type == "cuda":
        return _launch(A, B, lx, lu, lxx, luu, reg, pd_bump)
    if A.shape[0] == 1:
        K, kff = backward_pass_plain(*(t[0] for t in (A, B, lx, lu, lxx, luu, reg)), pd_bump)
        return K[None], kff[None]
    return torch.func.vmap(lambda *a: backward_pass_plain(*a, pd_bump))(A, B, lx, lu, lxx, luu,
                                                                        reg)


def _riccati_backward_vmap(info, in_dims, A, B, lx, lu, lxx, luu, reg, pd_bump):
    """The op under vmap: the vmapped dimension moved to the front (an
    unbatched input expanded to it) and merged with the op's own instance
    dimension, then one call: one launch on the card, the vmapped plain
    version on the CPU. No host read."""
    v = info.batch_size

    def flat(t, d):
        t = t.movedim(d, 0) if d is not None else t.unsqueeze(0).expand(v, *t.shape)
        return t.reshape(v * t.shape[1], *t.shape[2:]).contiguous()

    args = [flat(t, d) for t, d in zip((A, B, lx, lu, lxx, luu, reg), in_dims[:7])]
    K, kff = riccati_backward(*args, pd_bump)
    return (K.reshape(v, -1, *K.shape[1:]), kff.reshape(v, -1, *kff.shape[1:])), (0, 0)


torch.library.register_vmap(riccati_backward, _riccati_backward_vmap)


def backward_pass_kernel(A, B, lx, lu, lxx, luu, reg, pd_bump: float):
    """K4 — the whole backward pass in one launch: K (N, nu, nx), kff (N, nu)
    from A (N, nx, nx), B (N, nx, nu), lx (N+1, nx), lu (N, nu),
    lxx (N+1, nx, nx), luu (N, nu, nu) and λ (a scalar or 0-dim tensor).
    Under torch.func.vmap the instances go to one launch."""
    N, nx, nu = A.shape[0], A.shape[-1], B.shape[-1]
    args = (A, B, lx, lu, lxx, luu)
    shapes = [(N, nx, nx), (N, nx, nu), (N + 1, nx), (N, nu), (N + 1, nx, nx), (N, nu, nu)]
    if N < 1:
        raise ValueError("the Riccati backward pass needs N >= 1")
    on_card = _on_card(args, shapes)
    reg_t = torch.as_tensor(reg, dtype=torch.float32 if on_card else A.dtype, device=A.device)
    K, kff = riccati_backward(*(t[None] for t in args), reg_t.reshape(1), float(pd_bump))
    return K[0], kff[0]
