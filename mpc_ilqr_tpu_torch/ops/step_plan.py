"""The model packed for the CUDA rollout kernels.

`build_step_plan` flattens a RobotModel into one float32 and one int32
buffer on the model's device. The int buffer opens with a header of
`len(INT_HEADER)` entries — dims, then the offsets of every array — in the
order of the `PlanInt` enum in `csrc/step_layout.cuh`; the kernel copies
both buffers into shared memory and reads everything through the header.
Only free, hinge and fixed joints are packed (the kernels' step covers
those); anything else raises NotImplementedError.

Beside the tree, the plan packs the sparsity of the step (`step_lists`):
a body's Jacobian has columns at its ancestor dofs alone, so the kernel
computes Jacobian columns, velocities, M, the lhs and the bias only over
(body, dof) pairs on those lists, and over contact points only while they
touch the ground. Each list is ascending, so every kept term is added in
the order of the dense sum it replaces, and the terms skipped are exact
zeros.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpc_ilqr_tpu_torch.dynamics.kinematics import _tree_levels
from mpc_ilqr_tpu_torch.models.robot import JNT_FIXED, JNT_FREE, JNT_HINGE, RobotModel

# Mirrors `enum PlanInt` in csrc/step_layout.cuh, entry for entry.
INT_HEADER = (
    "B", "nq", "nv", "nu", "ncp", "nlev", "free_qpos", "free_dof", "free_body", "n_jac",
    "i_parent", "i_jtype", "i_qadr", "i_dadr", "i_lev_ptr", "i_lev_body",
    "i_cp_body", "i_dof_body", "i_dof_kind",
    "i_anc_ptr", "i_anc_dof", "i_jac_tgt", "i_jac_dof", "i_mov_ptr", "i_mov_body",
    "i_mcp_ptr", "i_mcp", "i_act_ptr", "i_act", "i_work_ptr", "i_work",
    "f_body_pos", "f_body_quat", "f_body_ipos", "f_body_iquat", "f_body_mass",
    "f_body_inertia", "f_jnt_axis", "f_jnt_pos", "f_dof_damping", "f_dof_armature",
    "f_act_gear", "f_gravity", "f_cp_pos", "f_cp_radius", "f_contact",
)
JOINT_CODE = {JNT_FREE: 0, JNT_HINGE: 1, JNT_FIXED: 2}  # enum JointCode
DOF_FREE_LIN, DOF_FREE_ANG, DOF_HINGE = 0, 1, 2  # enum DofKind
THREADS = 128  # threads of the block that runs one chain (kThreads in csrc/step_layout.cuh)
# The int sections that hold the model itself: its tree, its contact points'
# bodies and one entry per actuator (`i_act`, nu ints, stands for the map of
# actuators to dofs). The rest of the int buffer (header, levels, dof maps,
# the sparsity and work lists) is the kernels' schedule, derived from these.
MODEL_INTS = ("i_parent", "i_jtype", "i_qadr", "i_dadr", "i_cp_body", "i_act")


@dataclasses.dataclass(frozen=True, eq=False)
class StepPlan:
    fbuf: torch.Tensor  # float32, model arrays
    ibuf: torch.Tensor  # int32, header + structure
    B: int
    nq: int
    nv: int
    nu: int
    ncp: int


def _csr(lists):
    """(ptr, flat) of a list of int lists."""
    ptr = np.cumsum([0] + [len(x) for x in lists])
    flat = np.array([v for x in lists for v in x], np.int64)
    return ptr, flat


def step_lists(model: RobotModel) -> dict:
    """The sparsity lists of the step, as numpy int arrays (CSR: `*_ptr`
    holds each row's start in the flat array that follows it):

      anc_ptr, anc_dof   per body, its ancestor dofs (ancestor_mask's row)
      jac_tgt, jac_dof   every Jacobian column the step computes: (body b, dof
                         k) as (b, k) and (contact point c, dof k) as (B + c, k)
      mov_ptr, mov_body  per dof, the bodies it moves (ancestor_mask's column)
      mcp_ptr, mcp       per dof, the contact points it moves
      act_ptr, act       per dof, the actuators that drive it
      work_ptr, work     per thread of the block, its share of the assembly:
                         the lower-triangle entries (i, j) of M and the lhs
                         that are not structurally zero, as i·nv + j, and the
                         bias and tau rows i, as nv·nv + i; dealt longest
                         first to the least loaded thread

    Entry (i, j), i >= j, sums over the bodies that dof i moves: dof i's
    body lies below dof j's in the tree, so every body moved by i is moved
    by j (checked here)."""
    B, nv, ncp = model.nbody, model.nv, model.ncp
    anc = model.ancestor_mask.detach().cpu().numpy() != 0
    cp_body = list(model.cp_body_idx)
    anc_list = [list(np.flatnonzero(anc[b])) for b in range(B)]
    mov = [list(np.flatnonzero(anc[:, k])) for k in range(nv)]
    mcp = [[c for c in range(ncp) if anc[cp_body[c], k]] for k in range(nv)]
    act = [[a for a, d in enumerate(model.act_dof_adr) if d == k] for k in range(nv)]
    jac = [(b, k) for b in range(B) for k in anc_list[b]]
    jac += [(B + c, k) for c in range(ncp) for k in anc_list[cp_body[c]]]

    items = []  # (cost, item)
    for i in range(nv):
        for j in range(i + 1):
            if not (anc[:, i] & anc[:, j]).any():
                continue  # structurally zero
            if (anc[:, i] & ~anc[:, j]).any():
                raise NotImplementedError(
                    f"dof {i} moves a body that dof {j} < {i} does not: the CUDA rollout "
                    "kernels need parents' dofs numbered before their children's")
            items.append((3 * len(mov[i]) + 3 * len(mcp[i]), i * nv + j))
        items.append((2 * len(mov[i]) + len(mcp[i]) + len(act[i]), nv * nv + i))
    work, load = [[] for _ in range(THREADS)], [0] * THREADS
    for cost, item in sorted(items, key=lambda ci: -ci[0]):  # stable: ties keep their order
        th = int(np.argmin(load))
        work[th].append(item)
        load[th] += cost

    out = {}
    for name, lists in (("anc", anc_list), ("mov", mov), ("mcp", mcp), ("act", act),
                        ("work", work)):
        out[f"{name}_ptr"], flat = _csr(lists)
        out[{"anc": "anc_dof", "mov": "mov_body"}.get(name, name)] = flat
    out["jac_tgt"] = np.array([t for t, _ in jac], np.int64)
    out["jac_dof"] = np.array([k for _, k in jac], np.int64)
    return out


def model_bytes(plan: StepPlan) -> int:
    """Bytes of the model that a dynamics chain has to read: every float of
    the plan and its MODEL_INTS sections, not the schedule beside them."""
    ibuf = plan.ibuf.cpu().numpy()
    at = dict(zip(INT_HEADER, ibuf[: len(INT_HEADER)].tolist()))
    starts = [at[k] for k in INT_HEADER if k.startswith("i_")] + [ibuf.size]
    sizes = dict(zip((k for k in INT_HEADER if k.startswith("i_")), np.diff(starts)))
    return 4 * (plan.fbuf.numel() + int(sum(sizes[k] for k in MODEL_INTS)))


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

    lists = step_lists(model)
    ints = {
        "i_parent": model.body_parent,
        "i_jtype": [JOINT_CODE[j] for j in model.body_jnt_type],
        "i_qadr": model.body_qpos_adr,
        "i_dadr": model.body_dof_adr,
        "i_lev_ptr": lev_ptr,
        "i_lev_body": lev_body,
        "i_cp_body": model.cp_body_idx,
        "i_dof_body": dof_body,
        "i_dof_kind": dof_kind,
        **{f"i_{k}": v for k, v in lists.items()},
    }
    m = model
    contact = torch.stack([m.contact_stiffness, m.contact_damping, m.contact_friction,
                           m.contact_impratio]).reshape(-1)
    floats = {
        "f_body_pos": m.body_pos, "f_body_quat": m.body_quat, "f_body_ipos": m.body_ipos,
        "f_body_iquat": m.body_iquat, "f_body_mass": m.body_mass,
        "f_body_inertia": m.body_inertia, "f_jnt_axis": m.jnt_axis, "f_jnt_pos": m.jnt_pos,
        "f_dof_damping": m.dof_damping, "f_dof_armature": m.dof_armature,
        "f_act_gear": m.act_gear, "f_gravity": m.gravity,
        "f_cp_pos": m.cp_pos, "f_cp_radius": m.cp_radius, "f_contact": contact,
    }
    header = {
        "B": B, "nq": m.nq, "nv": nv, "nu": m.nu, "ncp": m.ncp, "nlev": len(levels),
        "free_qpos": m.body_qpos_adr[fb] if fb >= 0 else -1,
        "free_dof": m.body_dof_adr[fb] if fb >= 0 else -1,
        "free_body": fb, "n_jac": len(lists["jac_tgt"]),
    }
    ibody, at = [], len(INT_HEADER)
    for name in INT_HEADER:
        if name.startswith("i_"):
            header[name] = at
            vals = np.asarray(ints[name], np.int64).reshape(-1)
            ibody.append(vals)
            at += vals.size
    fbody, at = [], 0
    for name in INT_HEADER:
        if name.startswith("f_"):
            header[name] = at
            vals = floats[name].detach().to("cpu", torch.float64).numpy().reshape(-1)
            fbody.append(vals)
            at += vals.size
    ibuf = np.concatenate([np.array([header[k] for k in INT_HEADER], np.int64)] + ibody)
    fbuf = np.concatenate(fbody)
    return StepPlan(
        fbuf=torch.as_tensor(fbuf, dtype=torch.float32, device=m.device),
        ibuf=torch.as_tensor(ibuf.astype(np.int32), device=m.device),
        B=B, nq=m.nq, nv=nv, nu=m.nu, ncp=m.ncp,
    )
