"""iLQR solver (reference ilqr.cpp): Python loops around batched tensor work.

  rollout        K1 (`rollout_backend="pallas"`) or its plain loop ("xla")
  linearize      engine.step_and_jac ("structured*") or jvp / forward
                 differences of engine.step over the nx+nu directions
                 ("ad", "ad_frozen_mass", "fd"), vmapped over the horizon
  quadraticize   exact cost quadratics (quad_mode "exact") or Gauss-Newton
                 ("gn")
  backward       Riccati recursion with λ-regularization and one PD bump:
                 K4 in one launch (`backward="pallas"`), the loop below
                 ("scan") or the associative scan of ops/assoc_riccati.py
                 ("assoc", O(log N) depth)
  line search    cascade: α=1 alone (K2), then the other alphas in one
                 launch (K3) only on reject; or first_accept / argmin; or
                 a caller's `ls_fn` (parallel/sharded_solve.py)
  outer loop     the reference's adaptive regularization, retry, give-up
                 and divergence policy (ilqr.cpp:619-656)

`solve` decides on the host (early exit, one attempt only when the first is
accepted). `device_solve` is the same iteration with every decision a
tensor — fixed trips, carries frozen by `torch.where` — so it runs under
`torch.func.vmap` (`solve_batched`, parallel/fleet.py) and waits for the
device nowhere.

The backend names are the reference config's: "pallas" / "pallas_batched"
select the hand-written CUDA kernels (their plain versions on CPU tensors),
"xla" and "scan" select the plain loops.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
from torch.func import jvp, vmap

from mpc_ilqr_tpu_torch.costs.params import CostParams
from mpc_ilqr_tpu_torch.costs.quadratics import (
    CostQuadratics,
    quadraticize,
    trajectory_cost,
    trajectory_costs,
)
from mpc_ilqr_tpu_torch.costs.references import ReferenceWindow
from mpc_ilqr_tpu_torch.dynamics import engine
from mpc_ilqr_tpu_torch.models.robot import RobotModel, static_tensor
from mpc_ilqr_tpu_torch.ops import riccati
from mpc_ilqr_tpu_torch.ops import rollout_kernel as rk
from mpc_ilqr_tpu_torch.ops.assoc_riccati import backward_pass_assoc


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    """Solver configuration; defaults mirror ilqr.cpp:16 and ilqr.cpp:320.

    Same fields and defaults as the reference's ILQRConfig where ported:
    `ILQRConfig()` is the reference's default solver ("ad" + "exact");
    config.yaml ships "structured_frozen_mass" + "gn"."""

    N: int = 25
    max_iterations: int = 10
    tolerance: float = 1e-4
    reg_init: float = 1e-6
    reg_min: float = 1e-6
    reg_max: float = 1e-3
    pd_bump: float = 1e-4
    alphas: Tuple[float, ...] = (1.0, 0.8, 0.6, 0.4, 0.2, 0.1, 0.05, 0.01)
    accept_threshold: float = 1e-6
    divergence_threshold: float = 1e6
    # "reference": the line-search cost of ilqr.cpp:363-518; "full": the
    # objective the quadratics carry (costs/terms.py:stage_cost_full)
    cost_mode: str = "reference"
    n_substeps: int = 1  # physics substeps per horizon step (dt/physics_dt)
    line_search: str = "first_accept"  # "first_accept" | "argmin" | "cascade"
    backward: str = "scan"  # "scan": the Riccati loop below; "pallas": K4; "assoc"
    # "ad" (jvp over the nx+nu directions of engine.step), "ad_frozen_mass"
    # (the same with M(q) detached), "fd" (forward differences with fd_eps,
    # robot_utils.cpp:120-160), "structured" / "structured_frozen_mass"
    # (engine.step_and_jac: the same chain rule grouped by input block)
    linearization: str = "ad"
    rollout_backend: str = "xla"  # "pallas": K1
    ls_backend: str = "xla"  # "pallas": K2, "pallas_batched": K3
    cascade_p1_backend: str = "pallas"  # phase-1 (α=1) chain: K2 or "xla"
    inner_attempts: int = 2  # 2: retry a failed line search once with λ×10; 1: no retry
    quad_mode: str = "exact"  # jax.hessian's exact Hessians, or "gn" (Gauss-Newton)
    # "while" or "scan", kept for parity with the reference's config. Its
    # "scan" runs max_iterations trips and freezes the carry once done; a
    # frozen carry gives the solution and the iteration count of "while", so
    # both modes exit early here. The effective knob is linearize_every,
    # which only "scan" honours.
    outer_loop: str = "while"
    # With outer_loop="scan": linearize on every k-th trip only; the trips in
    # between reuse the previous trip's A, B and quadraticize anew.
    linearize_every: int = 1
    # The velocity solve of the plain rollout and line-search chains: "chol"
    # (factored) or "masked" (ops/linalg.spd_solve); the kernels ignore it.
    rollout_solver: str = "chol"
    fd_eps: float = 1e-5  # the "fd" perturbation (robot_utils.cpp:122)
    # Push linearize's input directions (the q-block's for "structured*") and
    # the cost x-Hessian's (the GN residual Jacobian's) in groups of this
    # size, one group after another: the same math at chunk/width of the
    # peak memory. 0: all at once.
    lin_chunk: int = 0
    hess_chunk: int = 0


_SUPPORTED = {
    "cost_mode": ("reference", "full"),
    "line_search": ("first_accept", "argmin", "cascade"),
    "backward": ("scan", "pallas", "assoc"),
    "outer_loop": ("while", "scan"),
    "linearization": ("ad", "ad_frozen_mass", "fd", "structured", "structured_frozen_mass"),
    "rollout_backend": ("xla", "pallas"),
    "ls_backend": ("xla", "pallas", "pallas_batched"),
    "cascade_p1_backend": ("xla", "pallas"),
    "quad_mode": ("exact", "gn"),
    "rollout_solver": ("chol", "masked"),
}


def check_config(cfg: ILQRConfig) -> None:
    for field, allowed in _SUPPORTED.items():
        if getattr(cfg, field) not in allowed:
            raise NotImplementedError(
                f"ILQRConfig.{field}={getattr(cfg, field)!r} is not ported; "
                f"this package has {allowed}")
    if cfg.linearize_every < 1:
        raise ValueError(f"ILQRConfig.linearize_every must be >= 1, got {cfg.linearize_every}")
    for field in ("lin_chunk", "hess_chunk"):
        if getattr(cfg, field) < 0:
            raise ValueError(f"ILQRConfig.{field} must be >= 0, got {getattr(cfg, field)}")


def vmap_safe(cfg: ILQRConfig) -> ILQRConfig:
    """The config to batch (reference `vmap_safe`): a cascade line search
    becomes first_accept (the same selection in one batch; batched, the
    cascade would run both phases for every instance) and the early-exit
    outer loop the fixed-trip "scan" (a batch runs to its slowest member)."""
    repl = {}
    if cfg.line_search == "cascade":
        repl["line_search"] = "first_accept"
    if cfg.outer_loop == "while":
        repl["outer_loop"] = "scan"
    return dataclasses.replace(cfg, **repl) if repl else cfg


def batched_config(cfg: ILQRConfig) -> ILQRConfig:
    """vmap_safe(cfg) on the plain chains: rollout_backend and ls_backend
    "xla". The batched path takes no StepPlan, as the reference's reaches
    its plain chains through plan=None. backward="pallas" stays: K4 runs a
    batch in one launch, one block per instance."""
    return dataclasses.replace(vmap_safe(cfg), rollout_backend="xla", ls_backend="xla")


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


def rollout(model: RobotModel, cfg: ILQRConfig, x0, us, plan=None) -> torch.Tensor:
    """Open-loop rollout: (N+1, nx) from x0 under us."""
    if cfg.rollout_backend == "pallas":
        return rk.rollout_kernel(model, plan, x0, us, cfg.n_substeps)
    return rk.rollout_plain(model, x0, us, cfg.n_substeps, solver=cfg.rollout_solver)


def linearize(model: RobotModel, cfg: ILQRConfig, xs, us):
    """A (N, nx, nx), B (N, nx, nu) at every knot, vmapped over the horizon.

    "structured*": engine.step_and_jac (q_chunk = lin_chunk). "ad" and
    "ad_frozen_mass": one jvp of engine.step per input direction of the
    concatenated (x, u); "fd": (f(xu + eps·e) − f(xu)) / eps per direction.
    Both take the nx+nu directions in groups of lin_chunk when it is set."""
    if cfg.linearization not in _SUPPORTED["linearization"]:
        raise ValueError(f"unknown ILQRConfig.linearization={cfg.linearization!r}; this "
                         f"package has {_SUPPORTED['linearization']}")
    frozen = cfg.linearization.endswith("frozen_mass")
    if cfg.linearization.startswith("structured"):
        _, A, B = vmap(lambda x, u: engine.step_and_jac(model, x, u, cfg.n_substeps, frozen,
                                                        q_chunk=cfg.lin_chunk))(xs[:-1], us)
        return A, B
    nx, nd = model.nx, model.nx + model.nu
    c = cfg.lin_chunk if 0 < cfg.lin_chunk < nd else nd
    groups = torch.eye(nd, dtype=xs.dtype, device=xs.device).split(c)
    f = lambda xu: engine.step(model, xu[:nx], xu[nx:], cfg.n_substeps, frozen)

    if cfg.linearization == "fd":
        eps = torch.as_tensor(cfg.fd_eps, dtype=xs.dtype, device=xs.device)

        def AB(x, u):
            xu = torch.cat([x, u])
            base = f(xu)
            J = torch.cat([vmap(lambda e: f(xu + eps * e))(E) - base[None] for E in groups])
            J = (J / eps).T
            return J[:, :nx], J[:, nx:]
    else:

        def AB(x, u):
            xu = torch.cat([x, u])
            J = torch.cat([vmap(lambda e: jvp(f, (xu,), (e,))[1])(E) for E in groups]).T
            return J[:, :nx], J[:, nx:]

    return vmap(AB)(xs[:-1], us)


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


def backward_pass_k4(A, B, quad: CostQuadratics, reg, pd_bump: float):
    """`backward_pass` by K4 (ops/riccati.py): one launch on the card, a
    batch of instances in one launch under vmap."""
    return riccati.backward_pass_kernel(*(t.contiguous() for t in (A, B, *quad)), reg, pd_bump)


def rollout_alphas(model: RobotModel, cp: CostParams, cfg: ILQRConfig, win: ReferenceWindow,
                   x0, xbar, ubar, K, kff, alphas, backend: str, plan=None):
    """Closed-loop rollouts u = ū + α k + K (x − x̄) of a batch of alphas on
    `backend` (ilqr.cpp:311-361) and their costs, a non-finite cost as inf:
    xs (A, N+1, nx), us (A, N, nu), costs (A,)."""
    if backend == "pallas_batched":
        xs_b, us_b = rk.linesearch_rollout_kernel_batched(
            model, plan, x0, xbar, ubar, K, kff, alphas, cfg.n_substeps)
    elif backend == "pallas":
        xs_b, us_b = rk.linesearch_rollout_kernel(
            model, plan, x0, xbar, ubar, K, kff, alphas, cfg.n_substeps)
    else:
        xs_b, us_b = rk.linesearch_rollout_batched_plain(
            model, x0, xbar, ubar, K, kff, alphas, cfg.n_substeps, solver=cfg.rollout_solver)
    costs = trajectory_costs(model, cp, win, xs_b, us_b, cfg.cost_mode)
    return xs_b, us_b, torch.where(torch.isfinite(costs), costs, torch.inf)


def pick_alpha(cfg: ILQRConfig, costs, baseline_cost):
    """(accepted, idx) as tensors: the first improving alpha (alphas are
    ordered descending) or, with line_search="argmin", the cheapest."""
    improves = costs < baseline_cost - cfg.accept_threshold
    if cfg.line_search == "argmin":
        return improves.any(), torch.argmin(costs)
    return improves.any(), torch.argmax(improves.to(torch.uint8))


def line_search(model: RobotModel, cp: CostParams, cfg: ILQRConfig, win: ReferenceWindow,
                x0, xbar, ubar, K, kff, baseline_cost, plan=None):
    """Closed-loop rollouts of the alphas (ilqr.cpp:311-361).

    Returns (accepted, xs, us, cost, best_cost): the selected alpha's
    trajectory — the largest improving alpha (first_accept, cascade) or the
    cheapest (argmin) — and the least cost over all alphas tried."""
    alphas = static_tensor(cfg.alphas, x0.device, x0.dtype)

    def roll_batch(alphas_b, backend):
        return rollout_alphas(model, cp, cfg, win, x0, xbar, ubar, K, kff, alphas_b, backend, plan)

    if cfg.line_search == "cascade" and len(cfg.alphas) > 1:
        # α=1 alone first; the other alphas, in order, only on reject.
        xs1, us1, c1 = roll_batch(alphas[:1], cfg.cascade_p1_backend)
        if bool(c1[0] < baseline_cost - cfg.accept_threshold):
            return True, xs1[0], us1[0], c1[0], c1[0]
        fb = "pallas_batched" if cfg.ls_backend == "pallas_batched" else "xla"
        xs_r, us_r, costs_r = roll_batch(alphas[1:], fb)
        accepted, idx = pick_alpha(cfg, costs_r, baseline_cost)
        idx = int(idx)
        return (bool(accepted), xs_r[idx], us_r[idx], costs_r[idx],
                torch.minimum(c1[0], costs_r.min()))

    xs_all, us_all, costs = roll_batch(alphas, cfg.ls_backend)
    accepted, idx = pick_alpha(cfg, costs, baseline_cost)
    idx = int(idx)
    return bool(accepted), xs_all[idx], us_all[idx], costs[idx], costs.min()


def line_search_device(model: RobotModel, cp: CostParams, cfg: ILQRConfig,
                       win: ReferenceWindow, x0, xbar, ubar, K, kff, baseline_cost):
    """`line_search` for first_accept or argmin on the plain chains, with
    the pick taken by tensor index: (accepted, xs, us, cost, best_cost),
    accepted a 0-dim bool tensor."""
    alphas = static_tensor(cfg.alphas, x0.device, x0.dtype)
    xs_all, us_all, costs = rollout_alphas(model, cp, cfg, win, x0, xbar, ubar, K, kff, alphas,
                                           "xla")
    accepted, idx = pick_alpha(cfg, costs, baseline_cost)
    take = lambda t: t.index_select(0, idx[None])[0]
    return accepted, take(xs_all), take(us_all), take(costs), costs.min()


def solve(model: RobotModel, cp: CostParams, cfg: ILQRConfig, x0, win: ReferenceWindow,
          ubar_init, xbar_init=None, reg0=None, plan=None, ls_fn=None) -> ILQRSolution:
    """Multi-iteration iLQR (iLQR::solve, ilqr.cpp:521-660).

    Each iteration linearizes and quadraticizes at the nominal trajectory,
    then makes up to `inner_attempts` (backward pass + line search) attempts,
    multiplying λ by 10 after a failed one. Convergence: |Δcost| < tol;
    divergence: cost > 1e6; give-up: no accepted step at iteration > 1.
    With outer_loop="scan" and linearize_every=k > 1, only every k-th
    iteration linearizes (see ILQRConfig).

    `ls_fn`, when given, replaces the line search with a function of the
    same contract (the reference's hook, mpc_ilqr_tpu/ilqr/solver.py:440):
        ls_fn(win, x0, xbar, ubar, K, kff, baseline) ->
            (accepted, xs, us, cost, best_cost)
    e.g. parallel/sharded_solve.py's search with its alphas spread over
    the ranks of a process group."""
    check_config(cfg)
    N, nu, nx = cfg.N, model.nu, model.nx
    dt, dev = x0.dtype, x0.device
    if xbar_init is None:
        xbar_init = rollout(model, cfg, x0, ubar_init, plan=plan)
    reg = torch.as_tensor(cfg.reg_init if reg0 is None else reg0, dtype=dt, device=dev)

    # Initial cost on the (possibly shifted) warm trajectory (ilqr.cpp:540),
    # then the nominal rolled once: an accepted line search stores its own
    # closed-loop trajectory, a rejected one leaves both unchanged, so the
    # nominal stays consistent with (x0, ubar) without re-rolling.
    cost = trajectory_cost(model, cp, win, xbar_init, ubar_init, cfg.cost_mode)
    xbar = rollout(model, cfg, x0, ubar_init, plan=plan)
    ubar = ubar_init
    K = torch.zeros((N, nu, nx), dtype=dt, device=dev)
    kff = torch.zeros((N, nu), dtype=dt, device=dev)
    it, done, attempts = 0, False, 0
    ever_accepted = stationary = diverged = False

    relinearize = 1 if cfg.outer_loop == "while" else cfg.linearize_every
    while not done and it < cfg.max_iterations:
        if it % relinearize == 0:
            A, B = linearize(model, cfg, xbar, ubar)
        quad = quadraticize(model, cp, win, xbar, ubar, cfg.hess_chunk, cfg.quad_mode)
        baseline = trajectory_cost(model, cp, win, xbar, ubar, cfg.cost_mode)

        reg_a, ok, best = reg, False, None
        for _ in range(1 if cfg.inner_attempts == 1 else 2):  # the reference retries once
            if cfg.backward == "pallas":
                K, kff = backward_pass_k4(A, B, quad, reg_a, cfg.pd_bump)
            elif cfg.backward == "assoc":
                K, kff = backward_pass_assoc(A, B, quad, reg_a, cfg.pd_bump)
            else:
                K, kff = backward_pass(A, B, quad, reg_a, cfg.pd_bump)
            if ls_fn is not None:
                ok, xs, us, c_new, best = ls_fn(win, x0, xbar, ubar, K, kff, baseline)
            else:
                ok, xs, us, c_new, best = line_search(
                    model, cp, cfg, win, x0, xbar, ubar, K, kff, baseline, plan=plan)
            attempts += 1
            if ok:
                break
            reg_a = torch.clamp(reg_a * 10.0, max=cfg.reg_max)

        # Stationary: nothing improved, but nothing moved the cost beyond the
        # tolerance either — the warm start is already optimal.
        stationary = stationary or (not ok and bool(best <= baseline + cfg.tolerance))
        converged = diverged_now = False
        if ok:
            converged = bool(torch.abs(c_new - cost) < cfg.tolerance)
            diverged_now = bool(c_new > cfg.divergence_threshold)
            cost, ubar, xbar = c_new, us, xs
            reg = torch.clamp(reg_a / 2.0, min=cfg.reg_min)
        else:
            reg = reg_a
        give_up = not ok and it > 1
        it += 1
        done = give_up or converged or diverged_now
        ever_accepted = ever_accepted or ok
        diverged = diverged or diverged_now

    success = (ever_accepted or stationary) and not diverged and bool(torch.isfinite(cost))
    return ILQRSolution(xbar=xbar, ubar=ubar, K=K, kff=kff, cost=cost, iterations=it,
                        reg=reg, success=success, attempts=attempts)


def _where(cond, new: dict, old: dict) -> dict:
    return {k: torch.where(cond, new[k], old[k]) for k in old}


def device_solve(model: RobotModel, cp: CostParams, cfg: ILQRConfig, x0, win: ReferenceWindow,
                 ubar_init, xbar_init=None, reg0=None) -> ILQRSolution:
    """`solve` of vmap_safe(cfg) with every decision made on the device (the
    reference's outer_loop="scan" form, mpc_ilqr_tpu/ilqr/solver.py:527-625).

    Exactly max_iterations trips (linearizing on every linearize_every-th);
    once an iteration finishes the solve (converged, diverged or given up),
    every carry stays frozen by `torch.where`. Each trip makes the
    inner_attempts (backward pass + line search) attempts always, the
    second masked where the first was accepted. The line search picks its
    alpha by tensor index; iterations and success are 0-dim tensors. No
    `bool()`, `int()` or `.item()`: it runs under `torch.func.vmap` and
    waits for the device nowhere. Takes no StepPlan: the plain chains only
    (rollout_backend and ls_backend "xla"); any backward, K4 ("pallas")
    with the attempt's λ, per instance under vmap."""
    cfg = vmap_safe(cfg)
    check_config(cfg)
    if (cfg.rollout_backend, cfg.ls_backend) != ("xla", "xla"):
        raise NotImplementedError(
            "device_solve runs the plain chains only (rollout_backend='xla', ls_backend='xla'); "
            "see batched_config and ROADMAP.md Queue 1 item 2")
    backward = {"assoc": backward_pass_assoc, "pallas": backward_pass_k4}.get(cfg.backward,
                                                                             backward_pass)
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
             cost=trajectory_cost(model, cp, win, xbar_init, ubar_init, cfg.cost_mode), reg=reg,
             it=torch.zeros((), dtype=torch.int64, device=dev), done=false,
             attempts=torch.zeros((), dtype=torch.int64, device=dev),
             ever_accepted=false, stationary=false, diverged=false)

    def attempt(A, B, quad, xbar, ubar, baseline, reg_a):
        K, kff = backward(A, B, quad, reg_a, cfg.pd_bump)
        ok, xs, us, cost, best = line_search_device(model, cp, cfg, win, x0, xbar, ubar, K, kff,
                                                    baseline)
        reg_next = torch.where(ok, reg_a, torch.clamp(reg_a * 10.0, max=cfg.reg_max))
        return dict(reg=reg_next, ok=ok, K=K, kff=kff, xs=xs, us=us, cost=cost, best=best)

    AB = None
    for trip in range(cfg.max_iterations):
        if trip % cfg.linearize_every == 0:
            AB = linearize(model, cfg, c["xbar"], c["ubar"])
        xbar, ubar = c["xbar"], c["ubar"]
        quad = quadraticize(model, cp, win, xbar, ubar, cfg.hess_chunk, cfg.quad_mode)
        baseline = trajectory_cost(model, cp, win, xbar, ubar, cfg.cost_mode)
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


def solve_batched(model: RobotModel, cp: CostParams, cfg: ILQRConfig, x0, win: ReferenceWindow,
                  ubar_inits) -> ILQRSolution:
    """`device_solve` of batched_config(cfg) over a leading batch of initial
    controls (B, N, nu) — warm-start seeds — sharing the model, x0 and the
    window (`jax.vmap(solve)` in tools/bench_suite.py:206). Every field of
    the solution gains the leading axis B."""
    cfg = batched_config(cfg)
    return ILQRSolution(*vmap(lambda u0: tuple(device_solve(model, cp, cfg, x0, win, u0)))(
        ubar_inits))
