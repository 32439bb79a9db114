"""[Frozen copy of mpc_ilqr_tpu_torch/costs/terms.py, lines 1-235, with its
imports made relative; the terms of the Gauss-Newton quadratics and of the
"reference" line-search cost only, the fleet's.]

Cost terms — functional twins of the reference cost library.

Weight conventions are the reference's, mixed 0.5 factors included:
- tracking:    0.5 eᵀQe + 0.5 eᵀRe            (ilqr.cpp:374-375)
- CoM pos/vel: w·‖e‖²                         (derivatives.cpp:548, 581)
- EE pos/vel:  w·‖e‖²                         (derivatives.cpp:608, 641)
- upright:     0.5·w·‖z_torso − ẑ‖²           (derivatives.cpp:650-667)
- balance:     0.5·w·‖p_cp − p_support‖²      (derivatives.cpp:671-704)
- soft limits: w·violation² with 10% margins  (robot_utils.cpp:615-672)

EE position cost only in swing, EE zero-velocity cost only in stance; the
balance support centre averages the in-stance feet's reference positions
and the term is skipped in flight. Every function takes one knot.
"""
from __future__ import annotations

import torch

from .params import CostParams
from . import kinematics as kin
from . import qmath as qm
from .robot import RobotModel, static_tensor


def _quat_log(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rotation vector of a unit quaternion, on the w >= 0 hemisphere."""
    q = torch.where(q[..., 0:1] < 0, -q, q)
    w, v = q[..., 0:1], q[..., 1:4]
    vn = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + eps)
    return v * (2.0 * torch.atan2(vn, w) / vn)


def tracking_cost(cp: CostParams, x, x_ref, u=None, u_ref=None, terminal=False, model=None):
    """Quadratic state/control tracking. With cp.quat_tangent and a floating
    base, the base-quaternion rows use the tangent error log(q_ref⁻¹ ⊗ q).
    The 0.5 scales each term before the sum (exact in binary): a python float
    times a 0-dim float32 tensor gets a float64 tangent under forward AD."""
    e = x - x_ref
    W = cp.Qf if terminal else cp.Q
    if cp.quat_tangent and model is not None and model.has_free_base:
        mask = torch.ones_like(e)
        mask[3:7] = 0.0
        dq = qm.quat_mul(qm.quat_conj(x_ref[3:7]), qm.quat_normalize(x[3:7]))
        delta = _quat_log(dq)
        c = torch.sum(0.5 * W * mask * e * e) + torch.sum(0.5 * W[4:7] * delta * delta)
    else:
        c = torch.sum(0.5 * W * e * e)
    if u is not None:
        eu = u - u_ref
        c = c + torch.sum(0.5 * cp.R * eu * eu)
    return c


def upright_residual(x):
    """Torso z-axis minus world z, from the base quaternion."""
    qw, qx, qy, qz = x[3:4], x[4:5], x[5:6], x[6:7]
    return torch.cat([2.0 * (qx * qz + qw * qy), 2.0 * (qy * qz - qw * qx),
                      1.0 - 2.0 * (qx * qx + qy * qy) - 1.0])


def upright_cost(cp: CostParams, x):
    r = upright_residual(x)
    return 0.5 * cp.w_upright * torch.sum(r * r)


def support_center(ee_ref, stance):
    """Mean xy of the in-stance feet's reference positions; `active` is 0
    when both feet are airborne."""
    denom = torch.sum(stance)
    active = (denom > 0).to(ee_ref.dtype)
    center = torch.sum(stance[:, None] * ee_ref[:, :2], dim=0) / torch.clamp(denom, min=1.0)
    return center, active


def balance_cost(model: RobotModel, cp: CostParams, x, ee_ref, stance):
    """Capture-point balance: p_cp = com_xy + vcom_xy·sqrt(h/g), with the
    base linear velocity for the CoM velocity, as the reference's
    line-search evaluation takes it (ilqr.cpp:411-413)."""
    com = kin.com_position(model, x[: model.nq])
    vcom = x[model.nq : model.nq + 3]
    omega0 = torch.sqrt(torch.clamp(com[2], min=1e-6) / cp.balance_g)
    r = com[:2] + vcom[:2] * omega0
    center, active = support_center(ee_ref, stance)
    r = r - center
    return active * 0.5 * cp.w_balance * torch.sum(r * r)


def joint_limit_cost(model: RobotModel, cp: CostParams, x):
    """Soft joint-range penalty with 10% margins."""
    if not model.limit_qpos_idx:
        return x.new_zeros(())
    qj = x[static_tensor(model.limit_qpos_idx, x.device)]
    lo, hi = model.limit_range[:, 0], model.limit_range[:, 1]
    margin = cp.limit_margin * (hi - lo)
    v_hi = torch.clamp(qj - (hi - margin), min=0.0)
    v_lo = torch.clamp((lo + margin) - qj, min=0.0)
    return cp.w_joint_limits * torch.sum(v_hi * v_hi + v_lo * v_lo)


def torque_limit_cost(model: RobotModel, cp: CostParams, u):
    """Soft ctrlrange penalty with 10% margins."""
    lo, hi = model.ctrl_range[:, 0], model.ctrl_range[:, 1]
    margin = cp.limit_margin * (hi - lo)
    v_hi = torch.clamp(u - (hi - margin), min=0.0)
    v_lo = torch.clamp((lo + margin) - u, min=0.0)
    return cp.w_torque_limits * torch.sum(v_hi * v_hi + v_lo * v_lo)


def task_residuals(model, cp, x, com_ref, com_vel_ref, ee_ref, stance, terminal=False):
    """The FK-dependent task terms as one weighted residual stack r(x):

        0.5 · ||r(x)||² == com + com_vel + ee_pos + ee_vel + upright + balance

    (w·||e||² rows carry sqrt(2w), 0.5·w·||e||² rows sqrt(w); the gates are
    per-knot constants). terminal=True drops the CoM-velocity rows."""
    feats = kin.task_features(model, x)
    s2 = lambda w: torch.sqrt(2.0 * w)
    s1 = lambda w: torch.sqrt(w)
    rows = [s2(cp.w_com) * (feats.com - com_ref)]
    if not terminal:
        rows.append(s2(cp.w_com_vel) * (feats.com_vel - com_vel_ref))
    if model.n_ee:
        swing = torch.sqrt(torch.clamp(1.0 - stance, min=0.0))
        rows.append(((s2(cp.w_ee_pos) * swing)[:, None] * (feats.ee_pos - ee_ref)).reshape(-1))
        rows.append(((s2(cp.w_ee_vel) * torch.sqrt(stance))[:, None] * feats.ee_vel).reshape(-1))
    if model.has_free_base:
        rows.append(s1(cp.w_upright) * upright_residual(x))
        if model.n_ee:
            center, active = support_center(ee_ref, stance)
            omega0 = torch.sqrt(torch.clamp(feats.com[2], min=1e-6) / cp.balance_g)
            p_cp = feats.com[:2] + feats.com_vel[:2] * omega0
            rows.append(s1(cp.w_balance * active) * (p_cp - center))
    return torch.cat(rows)


def stage_cost_eval(model, cp, x, u, x_ref, u_ref, com_ref, com_vel_ref, ee_ref, stance):
    """The cost the line search measures (cost_mode "reference"),
    iLQR::computeTotalCost (ilqr.cpp:363-518): tracking + upright + balance
    (base-velocity approximation) + soft limits; the CoM and EE terms the
    quadratics carry are not evaluated (the reference's inconsistency, kept)."""
    c = tracking_cost(cp, x, x_ref, u, u_ref, model=model)
    if model.has_free_base:
        c = c + upright_cost(cp, x)
        if model.n_ee:
            c = c + balance_cost(model, cp, x, ee_ref, stance)
    c = c + joint_limit_cost(model, cp, x)
    return c + torque_limit_cost(model, cp, u)


def terminal_cost_eval(model, cp, x, x_ref, com_ref, com_vel_ref, ee_ref, stance):
    c = tracking_cost(cp, x, x_ref, terminal=True, model=model)
    if model.has_free_base:
        c = c + upright_cost(cp, x)
        if model.n_ee:
            c = c + balance_cost(model, cp, x, ee_ref, stance)
    return c + joint_limit_cost(model, cp, x)
