"""The model packed for the CUDA rollout kernels.

`build_step_plan` flattens a RobotModel into one float32 and one int32
buffer on the model's device. The int buffer opens with a header of
`len(INT_HEADER)` entries — dims, then the offsets of every array — in the
order of the `PlanInt` enum in `csrc/step_layout.cuh`; the kernel copies
both buffers into shared memory and reads everything through the header.
Only free, hinge and fixed joints are packed (the kernels' step covers
those); anything else raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpc_ilqr_tpu_torch.dynamics.kinematics import _tree_levels
from mpc_ilqr_tpu_torch.models.robot import JNT_FIXED, JNT_FREE, JNT_HINGE, RobotModel

# Mirrors `enum PlanInt` in csrc/step_layout.cuh, entry for entry.
INT_HEADER = (
    "B", "nq", "nv", "nu", "ncp", "nlev", "free_qpos", "free_dof", "free_body",
    "i_parent", "i_jtype", "i_qadr", "i_dadr", "i_lev_ptr", "i_lev_body",
    "i_act_dof", "i_cp_body", "i_dof_body", "i_dof_kind",
    "f_body_pos", "f_body_quat", "f_body_ipos", "f_body_iquat", "f_body_mass",
    "f_body_inertia", "f_jnt_axis", "f_jnt_pos", "f_dof_damping", "f_dof_armature",
    "f_anc", "f_act_gear", "f_gravity", "f_cp_pos", "f_cp_radius", "f_contact",
)
JOINT_CODE = {JNT_FREE: 0, JNT_HINGE: 1, JNT_FIXED: 2}  # enum JointCode
DOF_FREE_LIN, DOF_FREE_ANG, DOF_HINGE = 0, 1, 2  # enum DofKind


@dataclasses.dataclass(frozen=True, eq=False)
class StepPlan:
    fbuf: torch.Tensor  # float32, model arrays
    ibuf: torch.Tensor  # int32, header + structure
    B: int
    nq: int
    nv: int
    nu: int
    ncp: int


def build_step_plan(model: RobotModel) -> StepPlan:
    unsupported = set(model.body_jnt_type) - set(JOINT_CODE)
    if unsupported:
        raise NotImplementedError(
            f"the CUDA rollout kernels support free/hinge/fixed joints only "
            f"(model has {sorted(unsupported)})")
    B, nv = model.nbody, model.nv
    levels = _tree_levels(model.body_parent, model.body_jnt_type)
    lev_body = [i for lv in levels for i in sorted(b for grp in lv.values() for b in grp)]
    lev_ptr = np.cumsum([0] + [sum(len(g) for g in lv.values()) for lv in levels])

    free = [i for i in range(B) if model.body_jnt_type[i] == JNT_FREE]
    if len(free) > 1:
        raise NotImplementedError("the CUDA rollout kernels support one free joint")
    fb = free[0] if free else -1
    dof_body = np.zeros(nv, np.int64)
    dof_kind = np.zeros(nv, np.int64)
    for i in range(B):
        d = model.body_dof_adr[i]
        if model.body_jnt_type[i] == JNT_FREE:
            dof_body[d : d + 6] = i
            dof_kind[d : d + 3] = DOF_FREE_LIN
            dof_kind[d + 3 : d + 6] = DOF_FREE_ANG
        elif model.body_jnt_type[i] == JNT_HINGE:
            dof_body[d] = i
            dof_kind[d] = DOF_HINGE

    ints = {
        "i_parent": model.body_parent,
        "i_jtype": [JOINT_CODE[j] for j in model.body_jnt_type],
        "i_qadr": model.body_qpos_adr,
        "i_dadr": model.body_dof_adr,
        "i_lev_ptr": lev_ptr,
        "i_lev_body": lev_body,
        "i_act_dof": model.act_dof_adr,
        "i_cp_body": model.cp_body_idx,
        "i_dof_body": dof_body,
        "i_dof_kind": dof_kind,
    }
    m = model
    contact = torch.stack([m.contact_stiffness, m.contact_damping, m.contact_friction,
                           m.contact_impratio]).reshape(-1)
    floats = {
        "f_body_pos": m.body_pos, "f_body_quat": m.body_quat, "f_body_ipos": m.body_ipos,
        "f_body_iquat": m.body_iquat, "f_body_mass": m.body_mass,
        "f_body_inertia": m.body_inertia, "f_jnt_axis": m.jnt_axis, "f_jnt_pos": m.jnt_pos,
        "f_dof_damping": m.dof_damping, "f_dof_armature": m.dof_armature,
        "f_anc": m.ancestor_mask, "f_act_gear": m.act_gear, "f_gravity": m.gravity,
        "f_cp_pos": m.cp_pos, "f_cp_radius": m.cp_radius, "f_contact": contact,
    }
    header = {
        "B": B, "nq": m.nq, "nv": nv, "nu": m.nu, "ncp": m.ncp, "nlev": len(levels),
        "free_qpos": m.body_qpos_adr[fb] if fb >= 0 else -1,
        "free_dof": m.body_dof_adr[fb] if fb >= 0 else -1,
        "free_body": fb,
    }
    ibody, at = [], len(INT_HEADER)
    for name, vals in ints.items():
        header[name] = at
        vals = np.asarray(vals, np.int64).reshape(-1)
        ibody.append(vals)
        at += vals.size
    fbody, at = [], 0
    for name, t in floats.items():
        header[name] = at
        vals = t.detach().to("cpu", torch.float64).numpy().reshape(-1)
        fbody.append(vals)
        at += vals.size
    ibuf = np.concatenate([np.array([header[k] for k in INT_HEADER], np.int64)] + ibody)
    fbuf = np.concatenate(fbody)
    return StepPlan(
        fbuf=torch.as_tensor(fbuf, dtype=torch.float32, device=m.device),
        ibuf=torch.as_tensor(ibuf.astype(np.int32), device=m.device),
        B=B, nq=m.nq, nv=nv, nu=m.nu, ncp=m.ncp,
    )
