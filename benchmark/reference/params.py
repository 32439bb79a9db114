"""[Frozen copy of mpc_ilqr_tpu_torch/costs/params.py, lines 1-85, with its imports made relative.]

Cost parameters and the Q/R/Qf diagonals (reference config.cpp:66-122).

The diagonals stay vectors (their off-diagonals are structurally zero).
"""
from __future__ import annotations

import dataclasses

import torch

from .robot import RobotModel

WEIGHT_FIELDS = (
    "Q", "R", "Qf", "w_com", "w_com_vel", "w_ee_pos", "w_ee_vel", "w_upright",
    "w_balance", "w_joint_limits", "w_torque_limits", "limit_margin", "balance_g",
)


@dataclasses.dataclass(frozen=True, eq=False)
class CostParams:
    """Cost weights. `quat_tangent` selects the tangent-space base
    orientation error instead of the raw quaternion difference."""

    Q: torch.Tensor  # (nx,) state tracking diag
    R: torch.Tensor  # (nu,) control effort diag
    Qf: torch.Tensor  # (nx,) terminal diag
    w_com: torch.Tensor  # CoM position tracking (W_com_pos)
    w_com_vel: torch.Tensor  # CoM velocity tracking (W_com_vel)
    w_ee_pos: torch.Tensor  # swing-foot position tracking (W_foot)
    w_ee_vel: torch.Tensor  # stance-foot zero-velocity (W_foot_vel)
    w_upright: torch.Tensor  # torso-upright penalty (W_upright)
    w_balance: torch.Tensor  # capture-point balance (w_balance)
    w_joint_limits: torch.Tensor  # soft joint-limit penalty
    w_torque_limits: torch.Tensor  # soft torque-limit penalty
    limit_margin: torch.Tensor  # fractional safety margin (0.1)
    balance_g: torch.Tensor  # gravity constant inside the capture point (9.81)
    quat_tangent: bool = False


def build_cost_params(model: RobotModel, weights: dict, constraints: dict,
                      dtype=None, quat_tangent: bool = False) -> CostParams:
    """Q/R/Qf diagonals as Config::buildCostMatrices builds them.

    Layout (nq=26): [pos(3), quat(4), joints(nq-7)] then velocities
    [lin(3), ang(3), joint(nv-6)]."""
    nq, nx, nu = model.nq, model.nx, model.nu
    Q = [1.0] * nx
    Q[0] = weights["Q_position_x"]
    Q[1] = weights["Q_position_y"]
    Q[2] = weights["Q_position_z"]
    Q[3] = weights["Q_quat_w"]
    Q[4], Q[5], Q[6] = weights["Q_quat_xyz"]
    for i in range(7, nq):
        Q[i] = weights["Q_joint_pos"]
    Q[nq + 0] = weights["Q_vel_x"]
    Q[nq + 1] = weights["Q_vel_y"]
    Q[nq + 2] = weights["Q_vel_z"]
    for i in range(nq + 3, nq + 6):
        Q[i] = weights["Q_ang_vel"]
    for i in range(nq + 6, nx):
        Q[i] = weights["Q_joint_vel"]

    R = [weights["R_control"]] * nu

    Qf = [qi * weights["Qf_multiplier"] for qi in Q]
    Qf[0] *= weights["Qf_position_x"]
    Qf[1] *= weights["Qf_position_y"]
    Qf[2] *= weights["Qf_position_z"]
    Qf[nq + 2] *= weights["Qf_vel_z"]

    c = lambda v: torch.as_tensor(v, dtype=dtype or model.dtype, device=model.device)
    return CostParams(
        Q=c(Q), R=c(R), Qf=c(Qf),
        w_com=c(weights.get("W_com_pos", 0.0)),
        w_com_vel=c(weights.get("W_com_vel", 0.0)),
        w_ee_pos=c(weights.get("W_foot", 0.0)),
        w_ee_vel=c(weights.get("W_foot_vel", 0.0)),
        w_upright=c(weights.get("W_upright", 0.0)),
        w_balance=c(weights.get("w_balance", 0.0)),
        w_joint_limits=c(constraints.get("joint_limit_weight", 500.0)),
        w_torque_limits=c(constraints.get("torque_limit_weight", 1000.0)),
        limit_margin=c(0.1),
        balance_g=c(9.81),
        quat_tangent=quat_tangent,
    )
