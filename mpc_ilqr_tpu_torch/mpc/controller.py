"""Receding-horizon MPC controller (reference mpc.cpp).

`step_once`: reference window → warm or cold start → iLQR solve → TV-LQR
control → state carry. `run_closed_loop` alternates it with the plant step
for n_steps. `step_once_device` is the same step with every decision a
tensor (`ilqr.device_solve`, an MPCState of tensors): what the fleet
batches.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from mpc_ilqr_tpu_torch.costs.params import CostParams
from mpc_ilqr_tpu_torch.costs.references import ReferenceSet, extract_window
from mpc_ilqr_tpu_torch.dynamics import engine
from mpc_ilqr_tpu_torch.ilqr import solver as ilqr
from mpc_ilqr_tpu_torch.models.robot import RobotModel


@dataclasses.dataclass(frozen=True, eq=False)
class MPCState:
    """Solve-to-solve carry (warm start + persistent regularization)."""

    t_idx: int  # position in the reference track (step_once_device: 0-dim int64)
    prev_xbar: torch.Tensor  # (N+1, nx)
    prev_ubar: torch.Tensor  # (N, nu)
    prev_K: torch.Tensor  # (N, nu, nx)
    has_prev: bool  # (step_once_device: 0-dim bool)
    reg: torch.Tensor  # () iLQR lambda, persists across solves

    def replace(self, **kw) -> "MPCState":
        return dataclasses.replace(self, **kw)


class MPCDiagnostics(NamedTuple):
    cost: torch.Tensor
    iterations: int
    reg: torch.Tensor
    solve_ok: bool
    attempts: int = 0  # (backward pass + line search) attempts the solve needed


def init_state(model: RobotModel, cfg: ilqr.ILQRConfig, dtype=None,
               tensors: bool = False) -> MPCState:
    """The empty carry; with tensors=True t_idx and has_prev are 0-dim
    tensors on the model's device (the state of step_once_device)."""
    dtype = dtype or model.dtype
    kw = dict(dtype=dtype, device=model.device)
    N, nx, nu = cfg.N, model.nx, model.nu
    return MPCState(
        t_idx=torch.zeros((), dtype=torch.int64, device=model.device) if tensors else 0,
        prev_xbar=torch.zeros((N + 1, nx), **kw),
        prev_ubar=torch.zeros((N, nu), **kw),
        prev_K=torch.zeros((N, nu, nx), **kw),
        has_prev=torch.zeros((), dtype=torch.bool, device=model.device) if tensors else False,
        reg=torch.tensor(cfg.reg_init, **kw),
    )


def reset(state: MPCState, cfg: ilqr.ILQRConfig) -> MPCState:
    """MPC::reset (mpc.cpp:130-149)."""
    return state.replace(
        t_idx=0,
        prev_xbar=torch.zeros_like(state.prev_xbar),
        prev_ubar=torch.zeros_like(state.prev_ubar),
        prev_K=torch.zeros_like(state.prev_K),
        has_prev=False,
        reg=torch.full_like(state.reg, cfg.reg_init),
    )


def _warm_start(model, cfg, x0, state: MPCState, plan=None):
    """Shift-by-one warm start (ilqr.cpp:68-81), or the gravity-comp cold
    start (ilqr.cpp:92-115) before the first successful solve."""
    if state.has_prev:
        ubar = torch.cat([state.prev_ubar[1:], state.prev_ubar[-1:]], dim=0)
        mid = state.prev_xbar[2:]  # x[t+1] = prev_x[t+2], t = 0..N-2
        x_last = engine.step(model, mid[-1], ubar[-1], cfg.n_substeps)
        return ubar, torch.cat([x0[None], mid, x_last[None]], dim=0)
    u_grav = engine.gravity_comp(model, x0)
    ubar = u_grav[None].repeat(cfg.N, 1)
    return ubar, ilqr.rollout(model, cfg, x0, ubar, plan=plan)


def step_once(model: RobotModel, cp: CostParams, cfg: ilqr.ILQRConfig, refs: ReferenceSet,
              state: MPCState, x_measured, plan=None, ls_fn=None):
    """MPC::stepOnce (mpc.cpp:40-127). Returns (new_state, u_apply, diagnostics).
    `ls_fn` swaps in another line search (`ilqr.solve`'s hook), e.g. the
    sharded one of parallel/sharded_solve.py."""
    win = extract_window(refs, state.t_idx, cfg.N)
    ubar0, xbar0 = _warm_start(model, cfg, x_measured, state, plan=plan)
    sol = ilqr.solve(model, cp, cfg, x_measured, win, ubar0, xbar0, reg0=state.reg, plan=plan,
                     ls_fn=ls_fn)

    # TV-LQR control law u = ū₀ + K₀ (x − x̄₀)  (mpc.cpp:97-101)
    u_tvlqr = sol.ubar[0] + sol.K[0] @ (x_measured - sol.xbar[0])
    ok = sol.success and bool(torch.isfinite(u_tvlqr).all())
    if ok:
        u_apply = u_tvlqr
        new_state = MPCState(t_idx=state.t_idx + 1, prev_xbar=sol.xbar, prev_ubar=sol.ubar,
                             prev_K=sol.K, has_prev=True, reg=state.reg)
    else:
        # Failure fallback (mpc.cpp:82-91): previous control, else zero; the
        # warm start and the time index stay as they were.
        u_apply = state.prev_ubar[0] if state.has_prev else torch.zeros_like(u_tvlqr)
        new_state = state
    # λ persists across solves even on failure, if it stayed finite.
    reg = sol.reg if bool(torch.isfinite(sol.reg)) else state.reg
    new_state = new_state.replace(reg=reg)
    diag = MPCDiagnostics(cost=sol.cost, iterations=sol.iterations, reg=sol.reg, solve_ok=ok,
                          attempts=sol.attempts)
    return new_state, u_apply, diag


def step_once_device(model: RobotModel, cp: CostParams, cfg: ilqr.ILQRConfig,
                     refs: ReferenceSet, state: MPCState, x_measured):
    """`step_once` with no host decision (the reference's step_once,
    mpc_ilqr_tpu/mpc/controller.py:90-138): the warm and the cold start are
    both computed and one selected by has_prev, the solve is
    `ilqr.device_solve` (so vmap_safe(cfg), plain chains), the failure
    fallback and the state carry are selects. `state` holds t_idx and
    has_prev as tensors (init_state(..., tensors=True)). Returns
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


def run_closed_loop(model: RobotModel, cp: CostParams, cfg: ilqr.ILQRConfig,
                    refs: ReferenceSet, state0: MPCState, x0, n_steps: int,
                    plant_model: RobotModel = None, plant_substeps: int = 1, plan=None):
    """Closed-loop MPC: n_steps of (step_once, plant step).

    Returns (final_state, final_x, history) with history holding per-step
    x, u, cost (stacked tensors) and iterations, solve_ok (lists)."""
    plant = plant_model if plant_model is not None else model
    state, x = state0, x0
    hist = {"x": [], "u": [], "cost": [], "iterations": [], "solve_ok": []}
    for _ in range(n_steps):
        state, u, diag = step_once(model, cp, cfg, refs, state, x, plan=plan)
        hist["x"].append(x)
        hist["u"].append(u)
        hist["cost"].append(diag.cost)
        hist["iterations"].append(diag.iterations)
        hist["solve_ok"].append(diag.solve_ok)
        x = engine.step(plant, x, u, plant_substeps)
    for k in ("x", "u", "cost"):
        hist[k] = torch.stack(hist[k])
    return state, x, hist


def tvlqr_control(state: MPCState, x_measured) -> torch.Tensor:
    """Inter-solve TV-LQR feedback (MPC::computeTVLQRControl, mpc.cpp:168-179)."""
    if not state.has_prev:
        return torch.zeros_like(state.prev_ubar[0])
    return state.prev_ubar[0] + state.prev_K[0] @ (x_measured - state.prev_xbar[0])
