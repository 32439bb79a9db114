"""[Frozen copy of mpc_ilqr_tpu_torch/ops/linalg.py, lines 1-59, with its imports made relative.]

Small-matrix SPD solves as plain tensor arithmetic (no LAPACK call).

The reference's masked right-looking Cholesky and masked substitutions
(`mpc_ilqr_tpu/ops/linalg.py`): one pivot at a time, rows masked by index,
the same algorithm as the in-kernel factor of the rollout kernels. Every
function takes one matrix or a leading batch of them (`...`) and composes
with `torch.func.vmap`.

Not for anything `jvp` differentiates: `cholesky_solve`'s tangent reuses the
factor, this unrolled form pays a tangent per pivot. `engine.step` takes it
only with solver="masked" (plain rollouts); `engine.step_and_jac` keeps the
factored solve.
"""
from __future__ import annotations

import torch


def cholesky_masked(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD (..., n, n), unrolled over n pivots.

    A non-positive pivot gives NaN (or inf) entries in its column and what
    follows, not an all-NaN factor."""
    n = A.shape[-1]
    rows = torch.arange(n, device=A.device)
    S, cols = A, []
    for k in range(n):
        colk = S[..., :, k]
        lk = torch.where(rows >= k, colk * torch.rsqrt(colk[..., k, None]), 0.0)
        cols.append(lk)
        if k < n - 1:  # the last update would touch nothing that is read
            S = S - lk[..., :, None] * lk[..., None, :]
    return torch.stack(cols, dim=-1)


def solve_tri_masked(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """X with (L Lᵀ) X = B for lower-triangular L (..., n, n), B (..., n, m):
    forward then backward substitution, each row a dot with the full
    (zero-padded) solution so far."""
    n = L.shape[-1]
    rows = L.unsqueeze(-2).unbind(-3)  # row k as (..., 1, n)
    cols = L.transpose(-1, -2).unsqueeze(-2).unbind(-3)  # column k as (..., 1, n)
    diag = torch.diagonal(L, dim1=-2, dim2=-1)[..., None].unbind(-2)  # (..., 1)
    Y = torch.zeros_like(B)
    for k, b_k in enumerate(B.unbind(-2)):  # rows j >= k of Y are still zero
        Y[..., k, :] = (b_k - torch.matmul(rows[k], Y).squeeze(-2)) / diag[k]
    X = torch.zeros_like(B)
    y = Y.unbind(-2)
    for k in reversed(range(n)):  # Lᵀ's rows are L's columns
        X[..., k, :] = (y[k] - torch.matmul(cols[k], X).squeeze(-2)) / diag[k]
    return X


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A⁻¹ b for SPD A (..., n, n); b (..., n) or (..., n, m)."""
    L = cholesky_masked(A)
    vec = b.dim() == A.dim() - 1
    X = solve_tri_masked(L, b[..., :, None] if vec else b)
    return X[..., :, 0] if vec else X
