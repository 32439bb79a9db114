"""Problem set-up from config.yaml (reference humanoid_mpc.cpp:94-118).

`setup(app, device=None)` builds the model, cost weights, solver config,
references and — when the config asks for the rollout kernels — the packed
StepPlan on `device` (default "cuda"; "cpu" only when asked).
"""
from __future__ import annotations

import dataclasses
import sys
from typing import NamedTuple

import torch

from mpc_ilqr_tpu_torch.costs.params import CostParams, build_cost_params
from mpc_ilqr_tpu_torch.costs.references import ReferenceSet
from mpc_ilqr_tpu_torch.ilqr.solver import ILQRConfig
from mpc_ilqr_tpu_torch.io import references as ioref
from mpc_ilqr_tpu_torch.io.config import AppConfig
from mpc_ilqr_tpu_torch.models.robot import RobotModel, load_robot
from mpc_ilqr_tpu_torch.ops.step_plan import StepPlan, build_step_plan


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
