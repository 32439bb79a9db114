"""The JAX package's benchmark set-ups (tools/bench_suite.py) for the port.

    long_horizon          N=100 replanning at 100 Hz on the standing
                          references (bench_suite.py:275-336, BASELINE config 4)
    tvlqr_amortized_loop  a solve every k-th control step, TV-LQR feedback
                          from the last solution in between (bench_suite.py:232-272)

No timing and no command line here: chip_smoke.py drives and times them.
"""
from __future__ import annotations

import copy
import dataclasses
import os

import torch

from mpc_ilqr_tpu_torch.dynamics import engine
from mpc_ilqr_tpu_torch.io.config import AppConfig, load_config
from mpc_ilqr_tpu_torch.mpc import controller, runner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUITE_STEPS = 15  # bench_suite.py --steps default


def long_horizon(app: AppConfig = None, *, backward: str = "pallas", tuned: bool = False,
                 iters: int = None, solve_every: int = 1, device=None):
    """The long-horizon problem and its control-step count.

    Applies bench_suite.py:283-322 to `app` (a copy; config.yaml when None):
    the standing references, dt = physics_dt = 0.01, N=100; with `tuned`
    the deployment knobs max_iterations=2, inner_attempts=1,
    linearize_every=2, outer_loop="scan"; then `backward` and, when given,
    max_iterations=`iters`. The step count is bench_suite's at --steps 15:
    5, or for solve_every=k > 1 the larger of 3k and 5 rounded down to k."""
    app = copy.deepcopy(app) if app is not None else load_config(os.path.join(ROOT, "config.yaml"))
    app.q_ref_path = "data/q_standing.csv"
    app.v_ref_path = "data/v_standing.csv"
    app.contact_schedule_path = "data/contact_standing.csv"
    app.mpc.dt = 0.01
    app.mpc.physics_dt = 0.01
    app.mpc.horizon = 100
    app.engine["backward"] = backward  # before setup, so that its kernel gate sees it
    prob = runner.setup(app, device=device)
    cfg = prob.cfg
    if tuned:
        cfg = dataclasses.replace(cfg, max_iterations=2, inner_attempts=1, linearize_every=2,
                                  outer_loop="scan")
    if iters is not None:
        cfg = dataclasses.replace(cfg, max_iterations=iters)
    n_steps = max(4, SUITE_STEPS // 3)
    if solve_every > 1:
        n_steps = max(3 * solve_every, (n_steps // solve_every) * solve_every)
    return prob._replace(cfg=cfg), n_steps


def tvlqr_amortized_loop(prob: runner.Problem, solve_every: int, state0: controller.MPCState,
                         x0, n_steps: int):
    """Closed loop that solves on every `solve_every`-th control step and
    applies u = ū_k + K_k (x − x̄_k) from the last solution on the steps in
    between (MPC::computeTVLQRControl, mpc.cpp:168-179), advancing t_idx on
    each of them so the next solve's reference window stays time-aligned.
    Runs n_steps // solve_every solve cycles.

    Returns (final_state, final_x, history): per control step x and u
    (stacked), per solve cost (stacked), iterations and solve_ok (lists)."""
    model, cp, cfg, refs = prob.model, prob.cp, prob.cfg, prob.refs
    state, x = state0, x0
    hist = {"x": [], "u": [], "cost": [], "iterations": [], "solve_ok": []}
    for _ in range(n_steps // solve_every):
        state, u, diag = controller.step_once(model, cp, cfg, refs, state, x, plan=prob.plan)
        hist["cost"].append(diag.cost)
        hist["iterations"].append(diag.iterations)
        hist["solve_ok"].append(diag.solve_ok)
        for k in range(solve_every):
            if k:
                u = state.prev_ubar[k] + state.prev_K[k] @ (x - state.prev_xbar[k])
                state = state.replace(t_idx=state.t_idx + 1)
            hist["x"].append(x)
            hist["u"].append(u)
            x = engine.step(model, x, u, cfg.n_substeps)
    for k in ("x", "u", "cost"):
        hist[k] = torch.stack(hist[k])
    return state, x, hist
