"""[Frozen copy of mpc_ilqr_tpu_torch/mpc/controller.py lines 23-61 (MPCState,
MPCDiagnostics, init_state) and 118-154 (step_once_device).]

One MPC step with no host decision: the warm and the cold start both
computed and one selected by has_prev, the device-side solve, the TV-LQR
control, the failure fallback and the state carry as selects.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .params import CostParams
from .references import ReferenceSet, extract_window
from . import engine
from . import solver as ilqr
from .robot import RobotModel


@dataclasses.dataclass(frozen=True, eq=False)
class MPCState:
    """Solve-to-solve carry (warm start + persistent regularization)."""

    t_idx: torch.Tensor  # position in the reference track, 0-dim int64
    prev_xbar: torch.Tensor  # (N+1, nx)
    prev_ubar: torch.Tensor  # (N, nu)
    prev_K: torch.Tensor  # (N, nu, nx)
    has_prev: torch.Tensor  # 0-dim bool
    reg: torch.Tensor  # () iLQR lambda, persists across solves

    def replace(self, **kw) -> "MPCState":
        return dataclasses.replace(self, **kw)


class MPCDiagnostics(NamedTuple):
    cost: torch.Tensor
    iterations: int
    reg: torch.Tensor
    solve_ok: bool
    attempts: int = 0  # (backward pass + line search) attempts the solve needed


def init_state(model: RobotModel, cfg: ilqr.ILQRConfig) -> MPCState:
    """The empty carry of step_once_device: t_idx and has_prev are 0-dim
    tensors on the model's device."""
    kw = dict(dtype=model.dtype, device=model.device)
    N, nx, nu = cfg.N, model.nx, model.nu
    return MPCState(
        t_idx=torch.zeros((), dtype=torch.int64, device=model.device),
        prev_xbar=torch.zeros((N + 1, nx), **kw),
        prev_ubar=torch.zeros((N, nu), **kw),
        prev_K=torch.zeros((N, nu, nx), **kw),
        has_prev=torch.zeros((), dtype=torch.bool, device=model.device),
        reg=torch.tensor(cfg.reg_init, **kw),
    )



def step_once_device(model: RobotModel, cp: CostParams, cfg: ilqr.ILQRConfig,
                     refs: ReferenceSet, state: MPCState, x_measured):
    """`step_once` with no host decision (the reference's step_once,
    mpc_ilqr_tpu/mpc/controller.py:90-138): the warm and the cold start are
    both computed and one selected by has_prev, the solve is
    `ilqr.device_solve` (so vmap_safe(cfg), plain chains), the failure
    fallback and the state carry are selects. `state` holds t_idx and
    has_prev as tensors (init_state). Returns
    (new_state, u_apply, diagnostics), iterations and solve_ok as tensors."""
    win = extract_window(refs, state.t_idx, cfg.N)
    # Shift-by-one warm start (ilqr.cpp:68-81), or the gravity-comp cold start.
    prev_u, prev_x = state.prev_ubar, state.prev_xbar
    ubar_w = torch.cat([prev_u[1:], prev_u[-1:]], dim=0)
    x_last = engine.step(model, prev_x[-1], ubar_w[-1], cfg.n_substeps)
    xbar_w = torch.cat([x_measured[None], prev_x[2:], x_last[None]], dim=0)
    ubar_c = engine.gravity_comp(model, x_measured)[None].repeat(cfg.N, 1)
    xbar_c = ilqr.rollout(model, cfg, x_measured, ubar_c)
    ubar0 = torch.where(state.has_prev, ubar_w, ubar_c)
    xbar0 = torch.where(state.has_prev, xbar_w, xbar_c)
    sol = ilqr.device_solve(model, cp, cfg, x_measured, win, ubar0, xbar0, reg0=state.reg)

    # TV-LQR control law u = ū₀ + K₀ (x − x̄₀)  (mpc.cpp:97-101)
    u_tvlqr = sol.ubar[0] + sol.K[0] @ (x_measured - sol.xbar[0])
    ok = sol.success & torch.isfinite(u_tvlqr).all()
    # Failure fallback (mpc.cpp:82-91): previous control, else zero; the warm
    # start and the time index stay as they were.
    u_fallback = torch.where(state.has_prev, prev_u[0], torch.zeros_like(u_tvlqr))
    keep = lambda new, old: torch.where(ok, new, old)
    new_state = MPCState(
        t_idx=keep(state.t_idx + 1, state.t_idx), prev_xbar=keep(sol.xbar, prev_x),
        prev_ubar=keep(sol.ubar, prev_u), prev_K=keep(sol.K, state.prev_K),
        has_prev=state.has_prev | ok,
        # λ persists across solves even on failure, if it stayed finite.
        reg=torch.where(torch.isfinite(sol.reg), sol.reg, state.reg))
    diag = MPCDiagnostics(cost=sol.cost, iterations=sol.iterations, reg=sol.reg, solve_ok=ok,
                          attempts=sol.attempts)
    return new_state, keep(u_tvlqr, u_fallback), diag
