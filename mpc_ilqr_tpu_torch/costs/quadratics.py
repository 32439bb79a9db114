"""Quadraticization of the cost along a trajectory, and the trajectory cost.

`quadraticize` is the exact form (quad_mode "exact", the reference's
CasADi-exact Hessians): grad and hessian of stage_cost_full under vmap.
`quadraticize_gn` is the Gauss-Newton form (quad_mode "gn"): the light part
(tracking + soft limits) gets its exact gradient and Hessian, the FK task
part 0.5·||r(x)||² gets lx = Jᵀr (exact) and lxx ≈ JᵀJ. lxu is
structurally zero (the stage cost is separable in x and u). hess_chunk
pushes the x-directions of the Hessian (exact) or of the residual Jacobian
(GN) in groups of that size, one group after another: the same math with a
peak memory of chunk/nx of the full sweep.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import grad, hessian, jacfwd, jvp, vmap

from mpc_ilqr_tpu_torch.costs import terms
from mpc_ilqr_tpu_torch.costs.params import CostParams
from mpc_ilqr_tpu_torch.costs.references import ReferenceWindow
from mpc_ilqr_tpu_torch.models.robot import RobotModel


class CostQuadratics(NamedTuple):
    lx: torch.Tensor  # (N+1, nx)
    lu: torch.Tensor  # (N, nu)
    lxx: torch.Tensor  # (N+1, nx, nx)
    luu: torch.Tensor  # (N, nu, nu)


def _jacfwd_chunked(f, n: int, chunk: int):
    """jacfwd(f) w.r.t. its first argument, its n directions pushed in
    groups of `chunk` one after another: (out, n) as jacfwd lays it out;
    plain jacfwd when chunk <= 0 or >= n."""
    if chunk <= 0 or chunk >= n:
        return jacfwd(f)

    def jac(x, *args):
        ff = lambda xx: f(xx, *args)
        groups = torch.eye(n, dtype=x.dtype, device=x.device).split(chunk)
        return torch.cat([vmap(lambda e: jvp(ff, (x,), (e,))[1])(E) for E in groups]).T

    return jac


def _hessian_chunked(f, n: int, chunk: int):
    """hessian(f) w.r.t. its first argument, forward over reverse in
    direction groups of `chunk`; plain hessian when chunk <= 0 or >= n."""
    return hessian(f) if chunk <= 0 or chunk >= n else _jacfwd_chunked(grad(f), n, chunk)


def _stage_u(model, cp):
    """The u-part of the stage cost (tracking + torque limits); lu and luu
    of both quad modes come from it."""
    def stage_u(u, x, x_ref, u_ref):
        return (terms.tracking_cost(cp, x, x_ref, u, u_ref, model=model)
                + terms.torque_limit_cost(model, cp, u))
    return stage_u


def quadraticize(model: RobotModel, cp: CostParams, win: ReferenceWindow,
                 xbar: torch.Tensor, ubar: torch.Tensor, hess_chunk: int = 0,
                 hess_mode: str = "exact") -> CostQuadratics:
    """lx, lxx from grad and hessian of stage_cost_full (terminal_cost_full
    at knot N), lu, luu from the tracking + torque-limit stage; hess_mode
    "gn" is quadraticize_gn."""
    if hess_mode == "gn":
        return quadraticize_gn(model, cp, win, xbar, ubar, hess_chunk=hess_chunk)
    if hess_mode != "exact":
        raise ValueError(f"unknown hess_mode {hess_mode!r}")
    N, nx = ubar.shape[0], xbar.shape[-1]

    def stage_x(x, u, x_ref, u_ref, com, com_vel, ee, stance):
        return terms.stage_cost_full(model, cp, x, u, x_ref, u_ref, com, com_vel, ee, stance)

    def term_x(x):
        return terms.terminal_cost_full(model, cp, x, win.x[N], win.com[N], win.com_vel[N],
                                        win.ee_pos[N], win.stance[N])

    xs = xbar[:N]
    args = (xs, ubar, win.x[:N], win.u, win.com[:N], win.com_vel[:N], win.ee_pos[:N],
            win.stance[:N])
    lx_s = vmap(grad(stage_x))(*args)
    lxx_s = vmap(_hessian_chunked(stage_x, nx, hess_chunk))(*args)
    stage_u = _stage_u(model, cp)
    lu = vmap(grad(stage_u))(ubar, xs, win.x[:N], win.u)
    luu = vmap(hessian(stage_u))(ubar, xs, win.x[:N], win.u)
    lx_N = grad(term_x)(xbar[N])
    lxx_N = hessian(term_x)(xbar[N])
    return CostQuadratics(
        lx=torch.cat([lx_s, lx_N[None]], dim=0), lu=lu,
        lxx=torch.cat([lxx_s, lxx_N[None]], dim=0), luu=luu,
    )


def quadraticize_gn(model: RobotModel, cp: CostParams, win: ReferenceWindow,
                    xbar: torch.Tensor, ubar: torch.Tensor, hess_chunk: int = 0) -> CostQuadratics:
    N, nx = ubar.shape[0], xbar.shape[-1]

    def light_x(x, x_ref):
        return terms.tracking_cost(cp, x, x_ref, model=model) + terms.joint_limit_cost(model, cp, x)

    def light_N(x):
        return (terms.tracking_cost(cp, x, win.x[N], terminal=True, model=model)
                + terms.joint_limit_cost(model, cp, x))

    def R_stage(x, com, com_vel, ee, stance):
        return terms.task_residuals(model, cp, x, com, com_vel, ee, stance)

    def R_N(x):
        return terms.task_residuals(model, cp, x, win.com[N], win.com_vel[N], win.ee_pos[N],
                                    win.stance[N], terminal=True)

    xs, xr = xbar[:N], win.x[:N]
    task = (xs, win.com[:N], win.com_vel[:N], win.ee_pos[:N], win.stance[:N])
    r_s = vmap(R_stage)(*task)  # (N, nr)
    J_s = vmap(_jacfwd_chunked(R_stage, nx, hess_chunk))(*task)  # (N, nr, nx)
    lx_s = vmap(grad(light_x))(xs, xr) + torch.einsum("tri,tr->ti", J_s, r_s)
    lxx_s = vmap(hessian(light_x))(xs, xr) + torch.einsum("tri,trj->tij", J_s, J_s)

    stage_u = _stage_u(model, cp)
    lu = vmap(grad(stage_u))(ubar, xs, xr, win.u)
    luu = vmap(hessian(stage_u))(ubar, xs, xr, win.u)

    r_N = R_N(xbar[N])
    J_N = jacfwd(R_N)(xbar[N])
    lx_N = grad(light_N)(xbar[N]) + torch.matmul(J_N.T, r_N)
    lxx_N = hessian(light_N)(xbar[N]) + torch.matmul(J_N.T, J_N)

    return CostQuadratics(
        lx=torch.cat([lx_s, lx_N[None]], dim=0), lu=lu,
        lxx=torch.cat([lxx_s, lxx_N[None]], dim=0), luu=luu,
    )


def trajectory_cost(model: RobotModel, cp: CostParams, win: ReferenceWindow,
                    xs: torch.Tensor, us: torch.Tensor, mode: str = "reference") -> torch.Tensor:
    """Total cost of a candidate trajectory (iLQR::computeTotalCost); mode
    as terms.stage_cost_eval's."""
    N = us.shape[0]
    stage = vmap(lambda x, u, xr, ur, com, cv, ee, st: terms.stage_cost_eval(
        model, cp, x, u, xr, ur, com, cv, ee, st, mode=mode))(
        xs[:N], us, win.x[:N], win.u, win.com[:N], win.com_vel[:N], win.ee_pos[:N],
        win.stance[:N])
    term = terms.terminal_cost_eval(model, cp, xs[N], win.x[N], win.com[N], win.com_vel[N],
                                    win.ee_pos[N], win.stance[N], mode=mode)
    return stage.sum() + term


def trajectory_costs(model: RobotModel, cp: CostParams, win: ReferenceWindow,
                     xs: torch.Tensor, us: torch.Tensor, mode: str = "reference") -> torch.Tensor:
    """trajectory_cost over a leading batch of candidates (A, N+1, nx)."""
    return vmap(lambda x, u: trajectory_cost(model, cp, win, x, u, mode))(xs, us)
