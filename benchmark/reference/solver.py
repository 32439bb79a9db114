"""[Frozen copy of the plain path of mpc_ilqr_tpu_torch/ilqr/solver.py: lines
52-105 (ILQRConfig), 155-169 (ILQRSolution), 178-246 (linearize,
backward_pass), 254-279 (rollout_alphas on the plain chains, pick_alpha),
311-322 (line_search_device) and 407-488 (device_solve, with the plain
Riccati loop as its only backward pass); and of mpc_ilqr_tpu_torch/ops/
rollout_kernel.py lines 37-43 and 61-75 (the plain rollouts). Only the
fleet's modes are copied (SUPPORTED); the configuration refuses others.]

The iLQR solve with every decision a tensor, as the fleet runs it: fixed
trips, both attempts always run, the alpha picked by tensor index. The
Riccati pass is `backward_pass`, a Python loop of torch.linalg: the
reference for the CUDA kernel the program launches there.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
from torch.func import vmap

from .params import CostParams
from .quadratics import CostQuadratics, quadraticize_gn, trajectory_cost, trajectory_costs
from .references import ReferenceWindow
from . import engine
from .robot import RobotModel, static_tensor

# What the reference computes, and the only values it takes of the options
# that change the math; another value is refused (`ILQRConfig.__post_init__`)
# rather than computed some other way. The fleet's solver (scenarios.FLEET_CFG).
SUPPORTED = dict(linearization=("structured_frozen_mass",), quad_mode=("gn",),
                 line_search=("first_accept",), cost_mode=("reference",),
                 outer_loop=("scan",), rollout_solver=("masked",))


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    """The solver's settings that the reference reads, with the program's
    field names."""

    N: int
    max_iterations: int
    tolerance: float
    reg_init: float
    reg_min: float
    reg_max: float
    pd_bump: float
    alphas: Tuple[float, ...]
    accept_threshold: float
    divergence_threshold: float
    cost_mode: str
    line_search: str
    linearization: str
    quad_mode: str
    outer_loop: str
    rollout_solver: str
    inner_attempts: int = 2  # 2: retry a failed line search once with λ×10; 1: no retry
    # linearize on every k-th trip only; the trips between reuse A, B
    linearize_every: int = 1
    n_substeps: int = 1  # physics substeps per horizon step (dt/physics_dt)

    def __post_init__(self):
        for field, allowed in SUPPORTED.items():
            if getattr(self, field) not in allowed:
                raise ValueError(f"the benchmark's reference computes {field} "
                                 f"{allowed[0]!r} only, not {getattr(self, field)!r}")


class ILQRSolution(NamedTuple):
    xbar: torch.Tensor  # (N+1, nx)
    ubar: torch.Tensor  # (N, nu)
    K: torch.Tensor  # (N, nu, nx)
    kff: torch.Tensor  # (N, nu)
    cost: torch.Tensor  # ()
    iterations: int
    reg: torch.Tensor  # () final lambda
    # finite cost AND (an accepted step OR stationary) AND not diverged
    success: bool
    # (backward pass + line search) attempts the solve needed; device_solve
    # runs inner_attempts on every trip, masked, whatever this says
    attempts: int = 0
    # (`device_solve` gives iterations, success and attempts as 0-dim tensors)



def rollout_plain(model: RobotModel, x0, us, n_substeps: int = 1, solver: str = "chol"):
    """xs (N+1, nx): x_{t+1} = step(x_t, u_t) (`solver`: engine.step's)."""
    xs = [x0]
    for t in range(us.shape[0]):
        xs.append(engine.step(model, xs[-1], us[t], n_substeps, solver=solver))
    return torch.stack(xs)



def linesearch_rollout_batched_plain(model: RobotModel, x0, xbar, ubar, K, kff, alphas,
                                     n_substeps: int = 1, solver: str = "chol"):
    """All alphas advanced together, one batched step per t."""
    step_b = vmap(lambda x, u: engine.step(model, x, u, n_substeps, solver=solver))
    x = x0[None].expand(alphas.shape[0], -1)
    xs, us = [x], []
    for t in range(ubar.shape[0]):
        u = ubar[t][None] + alphas[:, None] * kff[t][None] + torch.matmul(
            x - xbar[t][None], K[t].T)
        x = step_b(x, u)
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=1), torch.stack(us, dim=1)




def rollout(model: RobotModel, cfg: ILQRConfig, x0, us) -> torch.Tensor:
    """Open-loop rollout: (N+1, nx) from x0 under us."""
    return rollout_plain(model, x0, us, cfg.n_substeps, solver=cfg.rollout_solver)



def linearize(model: RobotModel, cfg: ILQRConfig, xs, us):
    """A (N, nx, nx), B (N, nx, nu) at every knot by engine.step_and_jac
    (M(q) frozen), vmapped over the horizon."""
    _, A, B = vmap(lambda x, u: engine.step_and_jac(model, x, u, cfg.n_substeps))(xs[:-1], us)
    return A, B


def backward_pass(A, B, quad: CostQuadratics, reg, pd_bump: float):
    """Riccati recursion (ilqr.cpp:250-309), t = N-1 .. 0. Returns K, kff."""
    N, nu = B.shape[0], B.shape[-1]
    I_u = torch.eye(nu, dtype=B.dtype, device=B.device)
    Vx, Vxx = quad.lx[-1], quad.lxx[-1]
    K_out, k_out = [None] * N, [None] * N
    for t in reversed(range(N)):
        At, Bt = A[t].T, B[t].T
        Qx = quad.lx[t] + At @ Vx
        Qu = quad.lu[t] + Bt @ Vx
        AtV = At @ Vxx
        BtV = Bt @ Vxx
        Qxx = quad.lxx[t] + AtV @ A[t]
        Qxu = AtV @ B[t]  # lxu ≡ 0 (separable costs)
        Quu = quad.luu[t] + BtV @ B[t] + reg * I_u
        # PD check with bump (ilqr.cpp:278-281); a failed factor is NaN.
        L, info = torch.linalg.cholesky_ex(Quu)
        bad = (info != 0) | ~torch.isfinite(L).all()
        Quu = Quu + bad.to(Quu.dtype) * pd_bump * I_u  # pd_bump in Quu's dtype
        L, info = torch.linalg.cholesky_ex(Quu)
        L = torch.where(info == 0, L, torch.full_like(L, float("nan")))
        K_t = -torch.cholesky_solve(Qxu.T, L)
        k_t = -torch.cholesky_solve(Qu[:, None], L)[:, 0]
        KT = K_t.T
        Vx = Qx + KT @ (Quu @ k_t) + KT @ Qu + Qxu @ k_t
        Vxx = Qxx + KT @ (Quu @ K_t) + KT @ Qxu.T + Qxu @ K_t
        Vxx = 0.5 * (Vxx + Vxx.T)
        K_out[t], k_out[t] = K_t, k_t
    return torch.stack(K_out), torch.stack(k_out)



def rollout_alphas(model: RobotModel, cp: CostParams, cfg: ILQRConfig, win: ReferenceWindow,
                   x0, xbar, ubar, K, kff, alphas):
    """Closed-loop rollouts u = ū + α k + K (x − x̄) of a batch of alphas on
    the plain chains (ilqr.cpp:311-361) and their costs, a non-finite cost
    as inf: xs (A, N+1, nx), us (A, N, nu), costs (A,)."""
    xs_b, us_b = linesearch_rollout_batched_plain(
        model, x0, xbar, ubar, K, kff, alphas, cfg.n_substeps, solver=cfg.rollout_solver)
    costs = trajectory_costs(model, cp, win, xs_b, us_b)
    return xs_b, us_b, torch.where(torch.isfinite(costs), costs, torch.inf)


def pick_alpha(costs, baseline_cost, accept_threshold: float):
    """(accepted, idx) as tensors: the first improving alpha (alphas are
    ordered descending)."""
    improves = costs < baseline_cost - accept_threshold
    return improves.any(), torch.argmax(improves.to(torch.uint8))



def line_search_device(model: RobotModel, cp: CostParams, cfg: ILQRConfig,
                       win: ReferenceWindow, x0, xbar, ubar, K, kff, baseline_cost):
    """The first_accept line search on the plain chains, with the pick
    taken by tensor index: (accepted, xs, us, cost, best_cost),
    accepted a 0-dim bool tensor."""
    alphas = static_tensor(cfg.alphas, x0.device, x0.dtype)
    xs_all, us_all, costs = rollout_alphas(model, cp, cfg, win, x0, xbar, ubar, K, kff, alphas)
    accepted, idx = pick_alpha(costs, baseline_cost, cfg.accept_threshold)
    take = lambda t: t.index_select(0, idx[None])[0]
    return accepted, take(xs_all), take(us_all), take(costs), costs.min()



def _where(cond, new: dict, old: dict) -> dict:
    return {k: torch.where(cond, new[k], old[k]) for k in old}


def device_solve(model: RobotModel, cp: CostParams, cfg: ILQRConfig, x0, win: ReferenceWindow,
                 ubar_init, xbar_init=None, reg0=None) -> ILQRSolution:
    """The fixed-trip iLQR solve (the reference's
    mpc_ilqr_tpu/ilqr/solver.py:527-625): exactly max_iterations trips
    (linearizing on every linearize_every-th); once an iteration finishes
    the solve (converged, diverged or given up), every carry stays frozen by
    `torch.where`. Each trip makes the inner_attempts (backward pass + line
    search) attempts always, the second masked where the first was
    accepted. Iterations, success and attempts are 0-dim tensors."""
    N, nu, nx = cfg.N, model.nu, model.nx
    dt, dev = x0.dtype, x0.device
    if xbar_init is None:
        xbar_init = rollout(model, cfg, x0, ubar_init)
    if reg0 is None:
        reg0 = cfg.reg_init
    reg = reg0.to(dt) if torch.is_tensor(reg0) else torch.full((), reg0, dtype=dt, device=dev)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    c = dict(xbar=rollout(model, cfg, x0, ubar_init), ubar=ubar_init,
             K=torch.zeros((N, nu, nx), dtype=dt, device=dev),
             kff=torch.zeros((N, nu), dtype=dt, device=dev),
             cost=trajectory_cost(model, cp, win, xbar_init, ubar_init), reg=reg,
             it=torch.zeros((), dtype=torch.int64, device=dev), done=false,
             attempts=torch.zeros((), dtype=torch.int64, device=dev),
             ever_accepted=false, stationary=false, diverged=false)

    def attempt(A, B, quad, xbar, ubar, baseline, reg_a):
        K, kff = backward_pass(A, B, quad, reg_a, cfg.pd_bump)
        ok, xs, us, cost, best = line_search_device(model, cp, cfg, win, x0, xbar, ubar, K, kff,
                                                    baseline)
        reg_next = torch.where(ok, reg_a, torch.clamp(reg_a * 10.0, max=cfg.reg_max))
        return dict(reg=reg_next, ok=ok, K=K, kff=kff, xs=xs, us=us, cost=cost, best=best)

    AB = None
    for trip in range(cfg.max_iterations):
        if trip % cfg.linearize_every == 0:
            AB = linearize(model, cfg, c["xbar"], c["ubar"])
        xbar, ubar = c["xbar"], c["ubar"]
        quad = quadraticize_gn(model, cp, win, xbar, ubar)
        baseline = trajectory_cost(model, cp, win, xbar, ubar)
        a = attempt(*AB, quad, xbar, ubar, baseline, c["reg"])
        needed = c["attempts"] + 1
        if cfg.inner_attempts != 1:  # the retry with λ×10, kept where the first failed
            needed = needed + (~a["ok"]).to(torch.int64)
            a = _where(a["ok"], a, attempt(*AB, quad, xbar, ubar, baseline, a["reg"]))
        ok = a["ok"]
        cost = torch.where(ok, a["cost"], c["cost"])
        converged = ok & (torch.abs(cost - c["cost"]) < cfg.tolerance)
        diverged = ok & (cost > cfg.divergence_threshold)
        give_up = ~ok & (c["it"] > 1)
        new = dict(xbar=torch.where(ok, a["xs"], xbar), ubar=torch.where(ok, a["us"], ubar),
                   K=a["K"], kff=a["kff"], cost=cost,
                   reg=torch.where(ok, torch.clamp(a["reg"] / 2.0, min=cfg.reg_min), a["reg"]),
                   it=c["it"] + 1, done=give_up | converged | diverged, attempts=needed,
                   ever_accepted=c["ever_accepted"] | ok,
                   # nothing improved, and nothing moved the cost beyond the tolerance
                   stationary=c["stationary"] | (~ok & (a["best"] <= baseline + cfg.tolerance)),
                   diverged=c["diverged"] | diverged)
        c = _where(c["done"], c, new)

    success = (c["ever_accepted"] | c["stationary"]) & ~c["diverged"] & torch.isfinite(c["cost"])
    return ILQRSolution(xbar=c["xbar"], ubar=c["ubar"], K=c["K"], kff=c["kff"], cost=c["cost"],
                        iterations=c["it"], reg=c["reg"], success=success,
                        attempts=c["attempts"])

