"""Quaternion-composition forward kinematics with one-hot tree gathers
(mpc_ilqr_tpu/ops/quat_fk.py), in plain PyTorch.

Rotations are carried as quaternions and composed elementwise; each tree
level's parent gather and child scatter is a product with a constant
one-hot matrix, built once per model as numpy and moved to the model's
device. It computes what `dynamics.kinematics.forward_kinematics` computes
(R = quat_to_mat(Q), p = P) and lies on no control path: it is the check
the reference keeps beside its matrix FK (tests/test_ops.py:89).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from mpc_ilqr_tpu_torch.dynamics import math as qm
from mpc_ilqr_tpu_torch.dynamics.kinematics import _tree_levels
from mpc_ilqr_tpu_torch.models.robot import JNT_FIXED, JNT_FREE, JNT_HINGE, RobotModel


class LevelPlan(NamedTuple):
    """One joint type of one tree level: constant one-hot matrices on the
    model's device, in its dtype."""

    kind: str  # "free" | "hinge" | "fixed"
    gather_parent: torch.Tensor  # (g, B): row r selects the parent of body_idx[r]
    scatter_child: torch.Tensor  # (B, g): column r places body_idx[r]
    qsel: torch.Tensor  # (g, nq): the hinge angle of body_idx[r] (hinge only)
    body_idx: Tuple[int, ...]  # the level's bodies of this kind


def build_level_plans(model: RobotModel) -> Tuple[LevelPlan, ...]:
    """The per-level plans of `model`'s tree (free, hinge and fixed joints)."""
    B, nq = model.nbody, model.nq
    unsupported = set(model.body_jnt_type) - {JNT_FREE, JNT_HINGE, JNT_FIXED}
    if unsupported:
        raise NotImplementedError(
            f"the quaternion FK plan takes free/hinge/fixed joints only (model has "
            f"{sorted(unsupported)})")
    as_t = lambda a: torch.as_tensor(a, dtype=model.dtype, device=model.device)
    plans = []
    for lv in _tree_levels(model.body_parent, model.body_jnt_type):
        for kind in (JNT_FREE, JNT_HINGE, JNT_FIXED):
            group = lv.get(kind, ())
            if not group:
                continue
            g = len(group)
            gp, sc, qs = np.zeros((g, B)), np.zeros((B, g)), np.zeros((g, nq))
            for r, i in enumerate(group):
                if model.body_parent[i] >= 0:
                    gp[r, model.body_parent[i]] = 1.0
                sc[i, r] = 1.0
                if kind == JNT_HINGE:
                    qs[r, model.body_qpos_adr[i]] = 1.0
            plans.append(LevelPlan(kind, as_t(gp), as_t(sc), as_t(qs), tuple(group)))
    return tuple(plans)


def quat_frames(model: RobotModel, plans: Tuple[LevelPlan, ...], q: torch.Tensor):
    """World body quaternions Q (B, 4) and positions P (B, 3) at q: one-hot
    gathers and quaternion composition, level by level. Every body row is
    written once, by its level's scatter."""
    B = model.nbody
    Q = q.new_zeros((B, 4))
    P = q.new_zeros((B, 3))
    for plan in plans:
        sc = plan.scatter_child
        if plan.kind == JNT_FREE:
            # the free root: its world pose is its qpos block
            a = model.body_qpos_adr[plan.body_idx[0]]
            Q = Q + sc @ qm.quat_normalize(q[a + 3:a + 7])[None]
            P = P + sc @ q[a:a + 3][None]
            continue
        cs = sc.T  # (g, B): the children's rows
        Qp, Pp = plan.gather_parent @ Q, plan.gather_parent @ P
        Qb, Pb = cs @ model.body_quat, cs @ model.body_pos
        Pi = Pp + qm.quat_rotate(Qp, Pb)
        Qi = qm.quat_mul(Qp, Qb)
        if plan.kind == JNT_HINGE:
            th = plan.qsel @ q
            ax, jp = cs @ model.jnt_axis, cs @ model.jnt_pos
            Qj = qm.quat_axis_angle(ax, th)
            Pi = Pi + qm.quat_rotate(Qi, jp - qm.quat_rotate(Qj, jp))
            Qi = qm.quat_mul(Qi, Qj)
        Q = Q + sc @ Qi
        P = P + sc @ Pi
    return Q, P

