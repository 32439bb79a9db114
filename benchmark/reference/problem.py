"""The reference's own problem, built from a configuration file of the
benchmark (benchmark/configs/*.json): the robot from its MJCF, the cost
weights, the reference tracks from their CSVs and the solver settings,
as `mpc_ilqr_tpu_torch.mpc.runner.setup` builds them from config.yaml
(runner.py:42-76, io/references.py:23-72), read with numpy here.
"""
from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from . import kinematics as kin
from .params import CostParams, build_cost_params
from .references import ReferenceSet
from .robot import RobotModel, load_robot
from .solver import ILQRConfig


class Problem(NamedTuple):
    model: RobotModel
    cp: CostParams
    cfg: ILQRConfig
    refs: ReferenceSet


def _csv(path: str, skip_rows: int = 0) -> np.ndarray:
    return np.atleast_2d(np.loadtxt(path, delimiter=",", skiprows=skip_rows, dtype=np.float64))


def reference_set(model: RobotModel, q_track, v_track, contact) -> ReferenceSet:
    """The tracks of io/references.py:build_reference_set: x = [q; v], a zero
    control reference, CoM, CoM velocity, foot positions and velocities of
    every row, and the contact schedule (stance past its end)."""
    dtype, dev = model.dtype, model.device
    T = min(len(q_track), len(v_track))
    q = torch.as_tensor(q_track[:T], dtype=dtype, device=dev)
    v = torch.as_tensor(v_track[:T], dtype=dtype, device=dev)
    sched = np.ones((T, len(model.ee_body_idx)))
    L = min(T, len(contact))
    sched[:L] = contact[:L]
    return ReferenceSet(
        x=torch.cat([q, v], dim=1),
        u=torch.zeros((T, model.nu), dtype=dtype, device=dev),
        com=vmap(lambda qq: kin.com_position(model, qq))(q),
        com_vel=vmap(lambda qq, vv: kin.com_velocity(model, qq, vv))(q, v),
        ee_pos=vmap(lambda qq: kin.ee_positions(model, qq))(q),
        ee_vel=vmap(lambda qq, vv: kin.ee_velocities(model, qq, vv))(q, v),
        stance=torch.as_tensor(sched, dtype=dtype, device=dev),
    )


def solver_config(config: dict) -> ILQRConfig:
    """The fleet's solver of a configuration file: its `solver` group on the
    horizon and the substeps of `dt` / `physics_dt`. The group's other keys
    pick the program's kernels (backward, rollout_backend, ls_backend,
    cascade_p1_backend) or bound its peak memory (lin_chunk, hess_chunk) and
    leave the math as it is; fd_eps serves a linearization the reference
    refuses. The reference runs its plain path, unchunked, whatever they say."""
    read = {f.name for f in dataclasses.fields(ILQRConfig)}
    s = {k: v for k, v in config["solver"].items() if k in read}
    s["alphas"] = tuple(s["alphas"])
    return ILQRConfig(N=int(config["horizon"]),
                      n_substeps=max(1, round(config["dt"] / config["physics_dt"])), **s)


def build(config: dict, root: str, device, dtype=torch.float64) -> Problem:
    """The configuration's problem in `dtype` on `device`; paths in the file
    are relative to `root` (the checkout)."""
    path = lambda p: os.path.join(root, p)
    robot, tracks = config["robot"], config["reference_trajectory"]
    model = load_robot(
        path(robot["model_path"]),
        ee_body_names=(robot["ee_feet"]["left_feet_ee"], robot["ee_feet"]["right_feet_ee"]),
        gravity=tuple(config["gravity"]), timestep=config["physics_dt"],
        contact_stiffness=config["contact_stiffness"], contact_damping=config["contact_damping"],
        contact_friction=config["contact_friction"], contact_impratio=config["contact_impratio"],
        dtype=dtype, device=device)
    cp = build_cost_params(model, config["cost_weights"], config["constraints"], dtype=dtype)
    refs = reference_set(model, _csv(path(tracks["q_ref"])), _csv(path(tracks["v_ref"])),
                         _csv(path(tracks["contact_schedule"]), skip_rows=1))
    return Problem(model=model, cp=cp, cfg=solver_config(config), refs=refs)
