"""The JAX package's benchmark set-ups (tools/bench_suite.py) for the port.

    long_horizon          N=100 replanning at 100 Hz on the standing
                          references (bench_suite.py:275-336, BASELINE config 4)
    tvlqr_amortized_loop  a solve every k-th control step, TV-LQR feedback
                          from the last solution in between (bench_suite.py:232-272)
    batched_linesearch    16 alphas × 8 warm-start seeds in one batched solve
                          (bench_suite.py:177-229, BASELINE config 3)
    fleet                 1024 domain-randomised H1s, one fleet MPC step in
                          chunks of 128 (bench_suite.py:339-403, BASELINE config 5)

No timing and no command line here: chip_smoke.py drives and times them.
"""
from __future__ import annotations

import copy
import dataclasses
import os
from typing import NamedTuple

import torch

from mpc_ilqr_tpu_torch.costs.references import ReferenceWindow, extract_window
from mpc_ilqr_tpu_torch.dynamics import engine
from mpc_ilqr_tpu_torch.io.config import AppConfig, load_config
from mpc_ilqr_tpu_torch.models.robot import RobotModel, standing_state
from mpc_ilqr_tpu_torch.mpc import controller, runner
from mpc_ilqr_tpu_torch.parallel import fleet as fleet_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUITE_STEPS = 15  # bench_suite.py --steps default
ALPHAS16 = (1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3, 0.2, 0.15, 0.1, 0.07, 0.05, 0.03, 0.02, 0.01)
FLEET_CFG = dict(max_iterations=2, line_search="first_accept", alphas=(1.0, 0.6, 0.2, 0.05),
                 rollout_solver="masked", inner_attempts=2, linearize_every=1)


def _standing(app: AppConfig = None, device=None, **overrides) -> runner.Problem:
    """bench_suite.py:_setup(standing=True, **overrides) on the plain chains:
    config.yaml (a copy of `app` when given) with the standing references,
    rollout_backend and ls_backend "xla" (no StepPlan: the batched solves
    take none), then the overrides."""
    app = copy.deepcopy(app) if app is not None else load_config(os.path.join(ROOT, "config.yaml"))
    app.q_ref_path = "data/q_standing.csv"
    app.v_ref_path = "data/v_standing.csv"
    app.contact_schedule_path = "data/contact_standing.csv"
    app.engine["rollout_backend"] = app.engine["ls_backend"] = "xla"
    prob = runner.setup(app, device=device)
    return prob._replace(cfg=dataclasses.replace(prob.cfg, **overrides))


class SeedSearch(NamedTuple):
    prob: runner.Problem
    x0: torch.Tensor  # (nx,) the standing state
    window: ReferenceWindow  # the references at t = 0
    seeds: torch.Tensor  # (n_seeds, N, nu) initial controls


def batched_linesearch(app: AppConfig = None, *, generator: torch.Generator = None,
                       n_seeds: int = 8, device=None) -> SeedSearch:
    """bench_suite.py:177-229: the standing problem with 16 alphas,
    max_iterations=3 and first_accept; seeds u_grav + 0.5·N(0, 1) of shape
    (n_seeds, N, nu) drawn from `generator` (seed 0 when None). Solve them
    in one batch with `ilqr.solver.solve_batched(prob.model, prob.cp,
    prob.cfg, x0, window, seeds)`."""
    prob = _standing(app, device, alphas=ALPHAS16, max_iterations=3,
                     line_search="first_accept")
    model, N = prob.model, prob.cfg.N
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    x0 = standing_state(model)
    noise = torch.randn((n_seeds, N, model.nu), generator=generator, dtype=model.dtype,
                        device=generator.device)
    seeds = engine.gravity_comp(model, x0)[None, None, :] + 0.5 * noise.to(model.device)
    return SeedSearch(prob=prob, x0=x0, window=extract_window(prob.refs, 0, N), seeds=seeds)


class Fleet(NamedTuple):
    prob: runner.Problem
    models: RobotModel  # batched: ARRAY_FIELDS with a leading fleet axis
    states: controller.MPCState  # fleet_init: the cold start
    xs: torch.Tensor  # (n, nx) the standing state, tiled
    chunk: int


def fleet(app: AppConfig = None, *, n: int = 1024, chunk: int = 128,
          generator: torch.Generator = None, device=None) -> Fleet:
    """bench_suite.py:339-403 at its defaults (fleet 1024, chunk 128): the
    standing problem with the fleet solver (max_iterations=2, first_accept,
    alphas (1.0, 0.6, 0.2, 0.05), rollout_solver "masked", inner_attempts 2,
    linearize_every 1; lin_chunk and hess_chunk 0), n models from
    `randomized_models` (seed 0 when no generator), the states of
    `fleet_init` and the standing state for every instance. Step it with
    `parallel.fleet.fleet_step_chunked(models, prob.cp, prob.cfg, prob.refs,
    states, xs, chunk)`."""
    prob = _standing(app, device, **FLEET_CFG)
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    models = fleet_mod.randomized_models(prob.model, generator, n)
    xs = standing_state(prob.model)[None].repeat(n, 1)
    return Fleet(prob=prob, models=models, states=fleet_mod.fleet_init(models, prob.cfg, n),
                 xs=xs, chunk=min(chunk, n))


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
