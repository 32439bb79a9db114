"""[Frozen copy of mpc_ilqr_tpu_torch/costs/quadratics.py, lines 1-155, with
its imports made relative; the Gauss-Newton form and the "reference" cost
only, the fleet's.]

Quadraticization of the cost along a trajectory, and the trajectory cost.

`quadraticize_gn` is the Gauss-Newton form (quad_mode "gn"): the light part
(tracking + soft limits) gets its exact gradient and Hessian, the FK task
part 0.5·||r(x)||² gets lx = Jᵀr (exact) and lxx ≈ JᵀJ. lxu is
structurally zero (the stage cost is separable in x and u).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import grad, hessian, jacfwd, vmap

from . import terms
from .params import CostParams
from .references import ReferenceWindow
from .robot import RobotModel


class CostQuadratics(NamedTuple):
    lx: torch.Tensor  # (N+1, nx)
    lu: torch.Tensor  # (N, nu)
    lxx: torch.Tensor  # (N+1, nx, nx)
    luu: torch.Tensor  # (N, nu, nu)


def _stage_u(model, cp):
    """The u-part of the stage cost (tracking + torque limits); lu and luu
    come from it."""
    def stage_u(u, x, x_ref, u_ref):
        return (terms.tracking_cost(cp, x, x_ref, u, u_ref, model=model)
                + terms.torque_limit_cost(model, cp, u))
    return stage_u


def quadraticize_gn(model: RobotModel, cp: CostParams, win: ReferenceWindow,
                    xbar: torch.Tensor, ubar: torch.Tensor) -> CostQuadratics:
    N = ubar.shape[0]

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
    J_s = vmap(jacfwd(R_stage))(*task)  # (N, nr, nx)
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
                    xs: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
    """Total cost of a candidate trajectory (iLQR::computeTotalCost), the
    cost the line search measures (cost_mode "reference")."""
    N = us.shape[0]
    stage = vmap(lambda x, u, xr, ur, com, cv, ee, st: terms.stage_cost_eval(
        model, cp, x, u, xr, ur, com, cv, ee, st))(
        xs[:N], us, win.x[:N], win.u, win.com[:N], win.com_vel[:N], win.ee_pos[:N],
        win.stance[:N])
    term = terms.terminal_cost_eval(model, cp, xs[N], win.x[N], win.com[N], win.com_vel[N],
                                    win.ee_pos[N], win.stance[N])
    return stage.sum() + term


def trajectory_costs(model: RobotModel, cp: CostParams, win: ReferenceWindow,
                     xs: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
    """trajectory_cost over a leading batch of candidates (A, N+1, nx)."""
    return vmap(lambda x, u: trajectory_cost(model, cp, win, x, u))(xs, us)
