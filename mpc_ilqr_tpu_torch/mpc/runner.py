"""Closed-loop simulation set-up and loop (reference main/humanoid_mpc.cpp).

`setup(app, device=None)` mirrors setupSimulation (humanoid_mpc.cpp:94-118):
the model, cost weights, solver config, references and — when the config
asks for the rollout kernels — the packed StepPlan on `device` (default
"cuda"; "cpu" only when asked). `run_simulation` mirrors runSimulation
(humanoid_mpc.cpp:122-190) step for step, as the JAX package's does. The
plant is the same differentiable engine the controller plans with.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from mpc_ilqr_tpu_torch.costs.params import CostParams, build_cost_params
from mpc_ilqr_tpu_torch.costs.references import ReferenceSet
from mpc_ilqr_tpu_torch.dynamics import engine
from mpc_ilqr_tpu_torch.ilqr.solver import ILQRConfig
from mpc_ilqr_tpu_torch.io import logging as iolog
from mpc_ilqr_tpu_torch.io import references as ioref
from mpc_ilqr_tpu_torch.io.config import AppConfig
from mpc_ilqr_tpu_torch.models.robot import RobotModel, load_robot, standing_state
from mpc_ilqr_tpu_torch.mpc import controller
from mpc_ilqr_tpu_torch.ops.step_plan import StepPlan, build_step_plan
from mpc_ilqr_tpu_torch.utils.profiling import Profiler, block_until_ready


class Problem(NamedTuple):
    model: RobotModel
    cp: CostParams
    cfg: ILQRConfig
    refs: ReferenceSet
    app: AppConfig
    plan: StepPlan = None  # packed model for the CUDA rollout kernels


def setup(app: AppConfig, device=None) -> Problem:
    """Build model, cost params, solver config and references from config."""
    device = torch.device("cuda" if device is None else device)
    dtype = torch.float64 if app.engine["dtype"] == "float64" else torch.float32
    model = load_robot(
        app.resolve(app.model_path),
        ee_body_names=(app.ee_feet["left_feet_ee"], app.ee_feet["right_feet_ee"]),
        gravity=tuple(app.mpc.gravity),
        timestep=app.mpc.physics_dt,
        contact_stiffness=app.engine["contact_stiffness"],
        contact_damping=app.engine["contact_damping"],
        contact_friction=app.engine["contact_friction"],
        contact_impratio=app.mpc.contact_impratio,
        dtype=dtype,
        device=device,
    )
    cp = build_cost_params(model, app.mpc.cost_weights, app.mpc.constraints, dtype=dtype,
                           quat_tangent=bool(app.engine.get("quat_tangent", False)))
    cfg = ILQRConfig(
        N=app.mpc.horizon,
        max_iterations=int(app.engine["max_iterations"]),
        tolerance=float(app.engine["tolerance"]),
        cost_mode=app.engine["cost_mode"],
        line_search=app.engine["line_search"],
        n_substeps=max(1, round(app.mpc.dt / app.mpc.physics_dt)),
        backward=app.engine.get("backward", "scan"),
        linearization=app.engine.get("linearization", "ad"),
        rollout_backend=app.engine.get("rollout_backend", "xla"),
        ls_backend=app.engine.get("ls_backend", "xla"),
        quad_mode=app.engine.get("quad_mode", "exact"),
    )
    refs = ioref.load_reference_set(
        model, app.resolve(app.q_ref_path), app.resolve(app.v_ref_path),
        app.resolve(app.contact_schedule_path), dtype=dtype)
    plan, cfg = build_plan_gated(model, cfg, dtype)
    return Problem(model=model, cp=cp, cfg=cfg, refs=refs, app=app, plan=plan)


def build_plan_gated(model: RobotModel, cfg: ILQRConfig, dtype):
    """Kernel gate: return (StepPlan | None, cfg).

    On CUDA the kernels take float32 models, and the rollout kernels models
    of free/hinge/fixed joints; a config that asks for them with any other
    model raises. On the CPU the kernels' plain versions run; a model the
    rollout kernels could not take drops to the plain loops with a notice,
    as the reference does.
    """
    if cfg.backward == "pallas" and model.device.type == "cuda" and dtype != torch.float32:
        raise ValueError("the CUDA Riccati kernel (backward='pallas') is float32-only")
    want = (cfg.rollout_backend == "pallas" or cfg.ls_backend in ("pallas", "pallas_batched")
            or (cfg.line_search == "cascade" and cfg.cascade_p1_backend == "pallas"))
    if not want:
        return None, cfg
    if model.device.type == "cuda":
        if dtype != torch.float32:
            raise ValueError("the CUDA rollout kernels are float32-only")
        return build_step_plan(model), cfg
    try:
        return build_step_plan(model), cfg
    except NotImplementedError as e:
        print(f"[mpc_ilqr_tpu_torch] rollout kernels unavailable for this model: {e}\n"
              f"[mpc_ilqr_tpu_torch] using the plain loops (rollout_backend='xla', "
              f"ls_backend='xla', cascade_p1_backend='xla')", file=sys.stderr)
        return None, dataclasses.replace(cfg, rollout_backend="xla", ls_backend="xla",
                                         cascade_p1_backend="xla")


def run_simulation(
    prob: Problem,
    sim_steps: Optional[int] = None,
    x0: Optional[torch.Tensor] = None,
    verbose: Optional[bool] = None,
    profiler: Optional[Profiler] = None,
    step_logger: Optional[iolog.StepLogger] = None,
    traj_logger: Optional[iolog.OptimalTrajectoryLogger] = None,
    sim_model: Optional[RobotModel] = None,
):
    """Run the closed-loop MPC sim; returns (history dict, final MPCState).

    Per step: NaN-guard the state (break); `step_once`, timed on the host
    clock up to a device synchronize and recorded as MPC_stepOnce; on a
    failed solve, gravity compensation of the plant model, and an abort
    after this step once past step 15 (humanoid_mpc.cpp:153-160); a
    non-finite control replaced by zeros; the log rows; the plant step (the
    plain `engine.step` of `sim_model`, max(1, round(dt/physics_dt))
    substeps); the per-step line. Two device-to-host copies per step: the
    state for the NaN guard, and one row holding the control, the cost, the
    reference row and the plan's first knot for the control guard, the logs
    and the line. `sim_model` (default: the controller's model) may be a
    `scale_robot_mass` / `set_gravity` variant: the kernels keep the plan of
    the controller's model."""
    model, cp, cfg, refs, app = prob.model, prob.cp, prob.cfg, prob.refs, prob.app
    sim_model = sim_model if sim_model is not None else model
    sim_steps = sim_steps if sim_steps is not None else app.mpc.sim_steps
    verbose = app.verbose if verbose is None else verbose
    prof = profiler or Profiler(enabled=False)
    physics_substeps = max(1, round(app.mpc.dt / app.mpc.physics_dt))
    np_dtype = torch.empty(0, dtype=model.dtype).numpy().dtype
    nq, nx, nu = model.nq, model.nx, model.nu
    cuts = np.cumsum([nu, 1, nx, nu, nq])  # u, cost, x_ref, u_ref, q_opt | u_opt

    x = standing_state(model) if x0 is None else x0
    state = controller.init_state(model, cfg)
    hist = {"x": [], "u": [], "cost": [], "solve_ms": [], "iterations": []}
    abort = False

    for step_i in range(sim_steps):
        xh = x.cpu().numpy().copy()  # a CPU tensor's numpy() would alias it
        if not np.isfinite(xh).all():
            print(f"NaN detected in state at step {step_i}, breaking.")
            break

        t0 = time.perf_counter()
        state, u_apply, diag = block_until_ready(
            controller.step_once(model, cp, cfg, refs, state, x, plan=prob.plan))
        solve_ms = (time.perf_counter() - t0) * 1e3
        prof.record("MPC_stepOnce", solve_ms)

        if not diag.solve_ok:
            # Gravity-compensation fallback (humanoid_mpc.cpp:153-160)
            u_apply = engine.gravity_comp(sim_model, x)
            if step_i > 15:
                abort = True

        row = min(step_i, refs.length - 1)
        host = torch.cat([u_apply, diag.cost.reshape(1), refs.x[row], refs.u[row],
                          state.prev_xbar[0, :nq], state.prev_ubar[0]]).double().cpu().numpy()
        u_np, cost, x_ref, u_ref, q_opt, u_opt = np.split(host, cuts)
        u_np, cost = u_np.astype(np_dtype), float(cost[0])
        if not np.isfinite(u_np).all():
            u_apply, u_np = torch.zeros_like(u_apply), np.zeros_like(u_np)

        if step_logger is not None:
            step_logger.log(step_i + 1, app.mpc.dt, cost, solve_ms, xh, u_np, x_ref, u_ref)
        if traj_logger is not None:
            traj_logger.log(step_i + 1, app.mpc.dt, q_opt.astype(np_dtype),
                            u_opt.astype(np_dtype))

        x = engine.step(sim_model, x, u_apply, physics_substeps)

        hist["x"].append(xh)
        hist["u"].append(u_np)
        hist["cost"].append(cost)
        hist["solve_ms"].append(solve_ms)
        hist["iterations"].append(int(diag.iterations))

        if verbose:
            print(
                f"Step {step_i}/{sim_steps} | Cost: {cost:.6g} | "
                f"(X,Y,Z): ({xh[0]:.6g},{xh[1]:.6g},{xh[2]:.6g}) m | "
                f"Control range: [{u_np.min():.6g}, {u_np.max():.6g}] | "
                f"solve: {solve_ms:.2f} ms"
            )
        if abort:
            print(f"MPC failed at step {step_i}, aborting after fallback.")
            break

    for lg in (step_logger, traj_logger):
        if lg is not None:
            lg.close()
    return hist, state
