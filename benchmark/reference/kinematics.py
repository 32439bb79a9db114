"""[Frozen copy of mpc_ilqr_tpu_torch/dynamics/kinematics.py, lines 1-220, with its imports made relative.]

Forward kinematics, Jacobians, CoM and task features on tensors.

The kinematic tree is processed one depth level at a time: the bodies of a
level (split by joint type) are one batch of 3×3 products, so a call costs
a few operations per level, not per body. Functions take one configuration
and compose with `torch.func.vmap` / `jvp` for batches and tangents; they
never write in place.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import qmath as qm
from .robot import (
    JNT_BALL,
    JNT_FIXED,
    JNT_FREE,
    JNT_HINGE,
    JNT_SLIDE,
    RobotModel,
    static_tensor,
)


class KinFrames(NamedTuple):
    """World-frame kinematic data for one configuration q."""

    R: torch.Tensor  # (B, 3, 3) body orientations
    p: torch.Tensor  # (B, 3) body frame origins
    dof_axis: torch.Tensor  # (nv, 3) world axis of each dof
    dof_anchor: torch.Tensor  # (nv, 3) world anchor point of rotational dofs
    dof_linear: torch.Tensor  # (nv,) 1.0 for translational dofs


@functools.lru_cache(maxsize=32)
def _tree_levels(body_parent: tuple, body_jnt_type: tuple):
    """Bodies grouped by tree depth, split by joint type: a list (one entry
    per level) of {joint_type: tuple(body indices)}."""
    B = len(body_parent)
    depth = [0] * B
    for i in range(B):
        depth[i] = 0 if body_parent[i] < 0 else depth[body_parent[i]] + 1
    levels = []
    for d in range(max(depth) + 1):
        idx = [i for i in range(B) if depth[i] == d]
        lv = {}
        for jt in (JNT_FREE, JNT_BALL, JNT_HINGE, JNT_SLIDE, JNT_FIXED):
            grp = tuple(i for i in idx if body_jnt_type[i] == jt)
            if grp:
                lv[jt] = grp
        levels.append(lv)
    return levels


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., 3, 3) @ (..., 3)."""
    return torch.matmul(M, v[..., None])[..., 0]


def forward_kinematics(model: RobotModel, q: torch.Tensor) -> KinFrames:
    """World poses of all bodies plus per-dof world axes and anchors.

    Free/ball/hinge/slide/fixed joints, one per body (multi-joint MJCF
    bodies are split into chains at load time)."""
    B, nv = model.nbody, model.nv
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    zero3 = q.new_zeros(3)
    R = [None] * B
    p = [None] * B
    W = [zero3] * nv  # dof world axes
    O = [zero3] * nv  # dof anchors (zero for translational dofs)
    lin = [0.0] * nv
    parent, qadr, dadr = model.body_parent, model.body_qpos_adr, model.body_dof_adr

    for level in _tree_levels(model.body_parent, model.body_jnt_type):
        for i in level.get(JNT_FREE, ()):
            a, d = qadr[i], dadr[i]
            Ri = qm.quat_to_mat(qm.quat_normalize(q[a + 3 : a + 7]))
            pi = q[a : a + 3]
            R[i], p[i] = Ri, pi
            for k in range(3):
                W[d + k] = eye[k]
                lin[d + k] = 1.0
                W[d + 3 + k] = Ri[:, k]  # body axes in world
                O[d + 3 + k] = pi

        for jt in (JNT_BALL, JNT_HINGE, JNT_SLIDE, JNT_FIXED):
            gi = list(level.get(jt, ()))
            if not gi:
                continue
            # World-rooted bodies: the parent frame is the world (R = I, p = 0).
            Rp = torch.stack([R[parent[i]] if parent[i] >= 0 else eye for i in gi])
            pp = torch.stack([p[parent[i]] if parent[i] >= 0 else zero3 for i in gi])
            g = static_tensor(gi, q.device)
            Ri = torch.matmul(Rp, qm.quat_to_mat(model.body_quat[g]))
            pi = pp + _mv(Rp, model.body_pos[g])
            if jt in (JNT_HINGE, JNT_BALL):
                jp = model.jnt_pos[g]
                ja = [qadr[i] for i in gi]
                if jt == JNT_HINGE:
                    Rj = qm.quat_to_mat(qm.quat_axis_angle(model.jnt_axis[g],
                                                           q[static_tensor(ja, q.device)]))
                else:  # ball: quaternion coordinate, rotation about jnt_pos
                    quat_g = torch.stack([q[a : a + 4] for a in ja])
                    norm = torch.sqrt(torch.sum(quat_g * quat_g, dim=-1, keepdim=True))
                    Rj = qm.quat_to_mat(quat_g / torch.clamp(norm, min=1e-12))
                # X_child = X_prejoint * Trans(jp) * Rot * Trans(-jp)
                pi = pi + _mv(Ri, jp - _mv(Rj, jp))
                Ri = torch.matmul(Ri, Rj)
                anchor = pi + _mv(Ri, jp)
                if jt == JNT_HINGE:
                    w = _mv(Ri, model.jnt_axis[g])
                    for r, i in enumerate(gi):
                        W[dadr[i]] = w[r]
                        O[dadr[i]] = anchor[r]
                else:
                    # Ball angular velocity is in the CHILD frame: dof axes
                    # are the columns of R_child.
                    for r, i in enumerate(gi):
                        for k in range(3):
                            W[dadr[i] + k] = Ri[r, :, k]
                            O[dadr[i] + k] = anchor[r]
            elif jt == JNT_SLIDE:
                ax = _mv(Ri, model.jnt_axis[g])
                pi = pi + ax * q[static_tensor([qadr[i] for i in gi], q.device)][:, None]
                for r, i in enumerate(gi):
                    W[dadr[i]] = ax[r]
                    lin[dadr[i]] = 1.0
            for r, i in enumerate(gi):
                R[i], p[i] = Ri[r], pi[r]

    lin_t = static_tensor(lin, q.device, q.dtype)
    return KinFrames(R=torch.stack(R), p=torch.stack(p), dof_axis=torch.stack(W),
                     dof_anchor=torch.stack(O), dof_linear=lin_t)


def point_jacobians(model: RobotModel, fr: KinFrames, body_idx, points_w: torch.Tensor):
    """Linear Jacobians (n, 3, nv) of world points points_w (n, 3) fixed on
    bodies `body_idx` (a static index list)."""
    mask = model.ancestor_mask[static_tensor(body_idx, points_w.device)]  # (n, nv)
    lin = fr.dof_linear[None, :, None]
    diff = points_w[:, None, :] - fr.dof_anchor[None, :, :]  # (n, nv, 3)
    rot = qm.cross(fr.dof_axis[None].expand_as(diff), diff)
    cols = lin * fr.dof_axis[None] + (1.0 - lin) * rot
    return (cols * mask[:, :, None]).transpose(-1, -2)


def body_jacobians(model: RobotModel, fr: KinFrames, points_w: torch.Tensor):
    """Point Jacobians for one point per body: Jv, Jw each (B, 3, nv)."""
    Jv = point_jacobians(model, fr, range(model.nbody), points_w)
    cols_w = ((1.0 - fr.dof_linear)[None, :, None] * fr.dof_axis[None]
              * model.ancestor_mask[:, :, None])
    return Jv, cols_w.transpose(-1, -2)


def body_com_positions(model: RobotModel, fr: KinFrames) -> torch.Tensor:
    """World positions of each body's CoM, shape (B, 3)."""
    return fr.p + _mv(fr.R, model.body_ipos)


def com_position(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """Total mass-weighted CoM."""
    pc = body_com_positions(model, forward_kinematics(model, q))
    m = model.body_mass
    return (m[:, None] * pc).sum(0) / m.sum()


def body_velocities(model: RobotModel, fr: KinFrames, v: torch.Tensor):
    """Angular velocity and CoM linear velocity of every body (world frame)."""
    Jv, Jw = body_jacobians(model, fr, body_com_positions(model, fr))
    return torch.matmul(Jw, v), torch.matmul(Jv, v)


def com_velocity(model: RobotModel, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    _, vc = body_velocities(model, forward_kinematics(model, q), v)
    m = model.body_mass
    return (m[:, None] * vc).sum(0) / m.sum()


def ee_positions(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """World positions of the end-effector body frames, (n_ee, 3)."""
    return forward_kinematics(model, q).p[static_tensor(model.ee_body_idx, q.device)]


def ee_velocities(model: RobotModel, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """World linear velocities of the end-effector body frames, (n_ee, 3)."""
    fr = forward_kinematics(model, q)
    idx = model.ee_body_idx
    return torch.matmul(point_jacobians(model, fr, idx, fr.p[static_tensor(idx, q.device)]), v)


class TaskFeatures(NamedTuple):
    """Every kinematic quantity the task costs consume, from one FK pass."""

    com: torch.Tensor  # (3,)
    com_vel: torch.Tensor  # (3,)
    ee_pos: torch.Tensor  # (n_ee, 3)
    ee_vel: torch.Tensor  # (n_ee, 3)


def task_features(model: RobotModel, x: torch.Tensor) -> TaskFeatures:
    q, v = model.split_state(x)
    fr = forward_kinematics(model, q)
    pc = body_com_positions(model, fr)
    m = model.body_mass
    msum = m.sum()
    com = (m[:, None] * pc).sum(0) / msum
    Jv, _ = body_jacobians(model, fr, pc)
    com_vel = (m[:, None] * torch.matmul(Jv, v)).sum(0) / msum
    if model.n_ee:
        idx = model.ee_body_idx
        pw = fr.p[static_tensor(idx, x.device)]
        ee_vel = torch.matmul(point_jacobians(model, fr, idx, pw), v)
    else:
        pw = x.new_zeros((0, 3))
        ee_vel = x.new_zeros((0, 3))
    return TaskFeatures(com=com, com_vel=com_vel, ee_pos=pw, ee_vel=ee_vel)
