"""Associative-scan Riccati backward pass, O(log N) depth
(mpc_ilqr_tpu/ops/assoc_riccati.py), in plain PyTorch.

Three phases replace the N serial steps of `solver.backward_pass`:

1. Vxx by a reverse associative scan of the value elements (A, C, J) with
   the Riccati (LFT) composition, Vxx_t = lxx_t + Aᵀ(I + Vxx' C)⁻¹ Vxx' A
   with C = B (luu + λI)⁻¹ Bᵀ;
2. Vx by a reverse associative scan of the affine recurrence
   Vx_t = c_t + M_t Vx_{t+1}, whose coefficients follow from Vxx;
3. the gains K, kff at every knot in one batch, each knot's Quu bumped by
   pd_bump on its own where its Cholesky factor fails.

λ folds into luu before the scan. `associative_scan` is the reference's
(jax.lax.associative_scan): pairs are combined, the half-length scan
recurses, and the even positions are filled in, so the composition tree is
the reference's, in about 2·log2(N+1) batched rounds and no loop over the
knots. Nothing raises or waits for the device: the solves and factors are
the `_ex` forms, and a singular or indefinite knot comes out non-finite, as
in the reference.
"""
from __future__ import annotations

import torch

from mpc_ilqr_tpu_torch.costs.quadratics import CostQuadratics


def _sym(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + M.transpose(-1, -2))


def _inv(M: torch.Tensor) -> torch.Tensor:
    """M⁻¹ by an LU solve against I (non-finite for a singular M)."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device).expand(M.shape)
    return torch.linalg.solve_ex(M, eye)[0]


def _interleave(even, odd):
    """x[0::2] = even, x[1::2] = odd along the leading axis (len(even) is
    len(odd) or one more)."""
    n = odd.shape[0]
    pairs = torch.stack([even[:n], odd], dim=1).reshape((2 * n,) + odd.shape[1:])
    return torch.cat([pairs, even[n:]], dim=0)


def associative_scan(fn, elems, reverse: bool = False):
    """Inclusive scan of a tuple of tensors along their leading axis with the
    associative `fn(a, b)`, a the element earlier in scan order (with
    reverse=True the scan runs from the last element, so `a` is the later
    one in time). The algorithm and its composition tree are
    jax.lax.associative_scan's."""
    if reverse:
        elems = tuple(e.flip(0) for e in elems)

    def scan(xs):
        n = xs[0].shape[0]
        if n < 2:
            return xs
        reduced = fn(tuple(x[0:-1:2] for x in xs), tuple(x[1::2] for x in xs))
        odd = scan(reduced)
        if n % 2 == 0:
            even = fn(tuple(o[:-1] for o in odd), tuple(x[2::2] for x in xs))
        else:
            even = fn(odd, tuple(x[2::2] for x in xs))
        even = tuple(torch.cat([x[:1], e], dim=0) for x, e in zip(xs, even))
        return tuple(_interleave(e, o) for e, o in zip(even, odd))

    out = scan(tuple(elems))
    return tuple(o.flip(0) for o in out) if reverse else out


def _combine_riccati(later, earlier):
    A2, C2, J2 = later
    A1, C1, J1 = earlier
    Z = _inv(torch.eye(A1.shape[-1], dtype=A1.dtype, device=A1.device) + C1 @ J2)
    A12 = A2 @ (Z @ A1)
    C12 = _sym(A2 @ (Z @ (C1 @ A2.transpose(-1, -2))) + C2)
    J12 = _sym(A1.transpose(-1, -2) @ (Z.transpose(-1, -2) @ (J2 @ A1)) + J1)
    return A12, C12, J12


def _combine_affine(later, earlier):
    M2, c2 = later
    M1, c1 = earlier
    return M1 @ M2, c1 + (M1 @ c2[..., None])[..., 0]


def backward_pass_assoc(A, B, quad: CostQuadratics, reg, pd_bump: float = 1e-4):
    """`solver.backward_pass`'s contract, parallel in N: A (N, nx, nx),
    B (N, nx, nu), the quadratics, λ (a float or a 0-dim tensor).
    Returns K (N, nu, nx), kff (N, nu)."""
    nx, nu = A.shape[-1], B.shape[-1]
    dt, dev = A.dtype, A.device
    I_x = torch.eye(nx, dtype=dt, device=dev)
    I_u = torch.eye(nu, dtype=dt, device=dev)

    luu_reg = quad.luu + reg * I_u
    # C_t = B luu_reg⁻¹ Bᵀ ;  b_t = −B luu_reg⁻¹ lu
    Bt = B.transpose(-1, -2)
    sol = torch.linalg.solve_ex(luu_reg, torch.cat([Bt, quad.lu[..., None]], dim=-1))[0]
    C = _sym(B @ sol[..., :nx])
    b = -(B @ sol[..., nx:])[..., 0]

    # Phase 1: Vxx. Elements (A_t, C_t, lxx_t) and the terminal (0, 0, lxx_N).
    zero = torch.zeros((1, nx, nx), dtype=dt, device=dev)
    _, _, Vxx = associative_scan(_combine_riccati, (torch.cat([A, zero]), torch.cat([C, zero]),
                                                    quad.lxx), reverse=True)

    # Phase 2: Vx. M_t = A_tᵀ (I + Vxx' C_t)⁻¹, c_t = lx_t + M_t Vxx' b_t.
    Vn = Vxx[1:]
    M = A.transpose(-1, -2) @ _inv(I_x + Vn @ C)
    c = quad.lx[:-1] + (M @ (Vn @ b[..., None]))[..., 0]
    _, Vx = associative_scan(_combine_affine, (torch.cat([M, zero]),
                                               torch.cat([c, quad.lx[-1:]])), reverse=True)
    vn = Vx[1:]

    # Phase 3: the gains at every knot, each knot bumped on its own.
    Qu = quad.lu + (Bt @ vn[..., None])[..., 0]
    Qux = Bt @ (Vn @ A)
    Quu = luu_reg + Bt @ (Vn @ B)
    L, info = torch.linalg.cholesky_ex(Quu)
    bad = (info != 0) | ~torch.isfinite(L).flatten(1).all(1)
    Quu = Quu + (bad.to(dt) * pd_bump)[:, None, None] * I_u  # pd_bump in Quu's dtype
    L, info = torch.linalg.cholesky_ex(Quu)
    L = torch.where((info == 0)[:, None, None], L, torch.full_like(L, float("nan")))
    K = -torch.cholesky_solve(Qux, L)
    kff = -torch.cholesky_solve(Qu[..., None], L)[..., 0]
    # contiguous, as the serial pass's: the feedback kernels (K2, K3) take K and kff so
    return K.contiguous(), kff.contiguous()
