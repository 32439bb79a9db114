"""The rollout kernels' packed plan (mpc_ilqr_tpu_torch/ops/step_plan.py),
numpy and the port's CPU engine only: the sparsity lists agree with the
model's ancestor mask, the constants mirror csrc/step_layout.cuh, and a numpy
mirror of the kernel's sparse assembly — its lists, its order, its skipped
contact points — gives the dense M, lhs, bias and tau of `engine` in float64.
"""
import os
import re

import numpy as np
import pytest
import torch

from mpc_ilqr_tpu_torch.dynamics import engine
from mpc_ilqr_tpu_torch.models.robot import (JNT_FIXED, JNT_FREE, JNT_HINGE, load_h1, load_robot,
                                             standing_state)
from mpc_ilqr_tpu_torch.ops.step_plan import (DOF_FREE_ANG, DOF_FREE_LIN, DOF_HINGE, INT_HEADER,
                                              JOINT_CODE, THREADS, build_step_plan, model_bytes,
                                              step_lists)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MJCF = os.path.join(ROOT, "robots/h1_description/mjcf")
# The flagship model settings of config.yaml's engine section.
H1_KW = dict(gravity=(0.0, 0.0, -1.0), timestep=0.02, contact_stiffness=5000.0,
             contact_damping=300.0, contact_impratio=100.0)


def _model(which, dtype=torch.float64):
    if which == "h1":
        return load_h1(device="cpu", dtype=dtype, **H1_KW)
    return load_robot(os.path.join(MJCF, "h1_with_hand.xml"), device="cpu", dtype=dtype, **H1_KW)


def _rows(ptr, flat):
    return [list(flat[ptr[i]: ptr[i + 1]]) for i in range(len(ptr) - 1)]


@pytest.mark.parametrize("which", ["h1", "h1_with_hand"])
def test_lists_agree_with_ancestor_mask(which):
    m = _model(which)
    anc = m.ancestor_mask.numpy() != 0
    L = step_lists(m)
    B, nv, ncp = m.nbody, m.nv, m.ncp
    assert _rows(L["anc_ptr"], L["anc_dof"]) == [list(np.flatnonzero(anc[b])) for b in range(B)]
    assert _rows(L["mov_ptr"], L["mov_body"]) == [list(np.flatnonzero(anc[:, k]))
                                                  for k in range(nv)]
    assert _rows(L["mcp_ptr"], L["mcp"]) == [
        [c for c in range(ncp) if anc[m.cp_body_idx[c], k]] for k in range(nv)]
    acts = _rows(L["act_ptr"], L["act"])
    assert sorted(a for k in range(nv) for a in acts[k]) == list(range(m.nu))
    assert all(m.act_dof_adr[a] == k for k in range(nv) for a in acts[k])
    cols = {(int(t), int(k)) for t, k in zip(L["jac_tgt"], L["jac_dof"])}
    want = {(b, k) for b in range(B) for k in np.flatnonzero(anc[b])}
    want |= {(B + c, k) for c in range(ncp) for k in np.flatnonzero(anc[m.cp_body_idx[c]])}
    assert cols == want and len(L["jac_tgt"]) == len(want)
    # The assembly: every structurally non-zero lower-triangle entry and every
    # bias row exactly once, spread over the block's threads.
    entries = [i * nv + j for i in range(nv) for j in range(i + 1) if (anc[:, i] & anc[:, j]).any()]
    assert sorted(L["work"].tolist()) == sorted(entries + [nv * nv + i for i in range(nv)])
    assert len(L["work_ptr"]) == THREADS + 1
    n_b = anc.sum(1)
    assert n_b.max() == {"h1": 11, "h1_with_hand": 16}[which]


@pytest.mark.parametrize("which", ["h1", "h1_with_hand"])
def test_model_bytes_count_the_model_not_the_schedule(which):
    """The kernels' bound reads model_bytes: the model's float arrays, its tree
    (parent, joint type, qpos and dof addresses per body), the contact points'
    bodies and the actuators, however long the schedule lists are."""
    m = _model(which)
    plan = build_step_plan(m)
    n_float = sum(t.numel() for t in (
        m.body_pos, m.body_quat, m.body_ipos, m.body_iquat, m.body_mass, m.body_inertia,
        m.jnt_axis, m.jnt_pos, m.dof_damping, m.dof_armature, m.act_gear, m.gravity, m.cp_pos,
        m.cp_radius)) + 4
    assert plan.fbuf.numel() == n_float
    assert model_bytes(plan) == 4 * (n_float + 4 * m.nbody + m.ncp + m.nu)
    assert model_bytes(plan) < 4 * (plan.fbuf.numel() + plan.ibuf.numel())


def test_plan_constants_mirror_cuda_layout():
    """INT_HEADER, the joint and dof codes and the thread count of the plan
    are the ones csrc/step_layout.cuh declares."""
    src = open(os.path.join(ROOT, "mpc_ilqr_tpu_torch/csrc/step_layout.cuh")).read()
    body = re.search(r"enum PlanInt \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"^\s*PI_(\w+)", body, re.M)
    assert [n.lower() for n in names[:-1]] == [n.lower() for n in INT_HEADER]
    assert names[-1] == "HEADER_LEN"
    assert int(re.search(r"constexpr int kThreads = (\d+);", src).group(1)) == THREADS
    codes = dict(re.findall(r"\b(JC_\w+|DK_\w+) = (\d+)", src))
    assert [int(codes[f"JC_{k}"]) for k in ("FREE", "HINGE", "FIXED")] == [
        JOINT_CODE[j] for j in (JNT_FREE, JNT_HINGE, JNT_FIXED)]
    assert [int(codes[f"DK_{k}"]) for k in ("FREE_LIN", "FREE_ANG", "HINGE")] == [
        DOF_FREE_LIN, DOF_FREE_ANG, DOF_HINGE]
    plan = build_step_plan(_model("h1", torch.float32))
    ib = plan.ibuf.numpy()
    hdr = dict(zip(INT_HEADER, ib[: len(INT_HEADER)]))
    L = step_lists(_model("h1"))
    for name, vals in L.items():  # each list sits at its header offset
        at = hdr[f"i_{name}"]
        np.testing.assert_array_equal(ib[at: at + len(vals)], vals)
    assert hdr["n_jac"] == len(L["jac_tgt"])


def _dense_terms(m, x, u):
    """engine's dense M, lhs, bias, tau at x, and the per-body quantities the
    kernel's assembly reads (all float64)."""
    h = m.timestep
    q, v = m.split_state(engine.normalize_state(m, x))
    fr, pc, Jv_f, Jw = engine._frames_and_jacs(m, q)
    G = engine._principal_rotate(m, fr, Jw, transpose=True)
    Jw_f = engine._flat(Jw)
    omega = torch.matmul(Jw_f, v).reshape(-1, 3)
    alpha, acc = engine._body_accelerations(m, fr, v, omega, pc)
    fb = m.body_mass[:, None] * (acc - m.gravity[None, :])
    nb = engine._apply_world_inertia(m, fr, alpha) + torch.linalg.cross(
        omega, engine._apply_world_inertia(m, fr, omega))
    Jp, f_el, fn_el, active, _ = engine.contact_geometry(m, fr)
    Jc = engine._flat(Jp)
    cd = engine.contact_cdiag(m, Jc, fn_el, active, v, h)
    M = engine.mass_matrix(m, q)
    lhs = M + h * torch.diag(m.dof_damping) + h * torch.matmul(Jc.T, Jc * cd.reshape(-1)[:, None])
    tau = engine.applied_torques(m, u) + torch.matmul(Jc.T, f_el.reshape(-1))
    dense = {"M": M, "lhs": lhs, "bias": engine.bias_forces(m, q, v), "tau": tau}
    parts = dict(Jv=Jv_f, Jw=Jw_f, G=engine._flat(G), Jc=Jc, cd=cd.reshape(-1),
                 fb=fb.reshape(-1), nb=nb.reshape(-1), fel=f_el.reshape(-1), act=active)
    return ({k: t.numpy() for k, t in dense.items()}, {k: t.numpy() for k, t in parts.items()})


def _sparse_assembly(m, L, P, u):
    """The kernel's assembly (csrc/step.cuh: assemble), thread by thread,
    term by term, in its order."""
    nv, h = m.nv, m.timestep
    mass, inertia = m.body_mass.numpy(), m.body_inertia.numpy()
    arm, damp, gear = m.dof_armature.numpy(), m.dof_damping.numpy(), m.act_gear.numpy()
    mov, mcp = _rows(L["mov_ptr"], L["mov_body"]), _rows(L["mcp_ptr"], L["mcp"])
    acts = _rows(L["act_ptr"], L["act"])
    Jv, Jw, G, Jc, cd = P["Jv"], P["Jw"], P["G"], P["Jc"], P["cd"]
    M, lhs = np.zeros((nv, nv)), np.zeros((nv, nv))
    bias, tau = np.zeros(nv), np.zeros(nv)
    for item in L["work"]:
        if item >= nv * nv:
            i = int(item) - nv * nv
            bias[i] = sum(Jv[r, i] * P["fb"][r] + Jw[r, i] * P["nb"][r]
                          for b in mov[i] for r in range(3 * b, 3 * b + 3))
            ts = sum(gear[a] * u[a] for a in acts[i])
            tc = sum(Jc[3 * c + 2, i] * P["fel"][3 * c + 2] for c in mcp[i] if P["act"][c] != 0.0)
            tau[i] = ts + tc
            continue
        i, j = divmod(int(item), nv)
        s = 0.0
        for b in mov[i]:
            for r in range(3):
                row = 3 * b + r
                s += mass[b] * Jv[row, i] * Jv[row, j] + G[row, i] * inertia[b, r] * G[row, j]
        if i == j:
            s += arm[i]
        cs = 0.0
        for c in mcp[i]:
            if P["act"][c] == 0.0:
                continue
            for r in range(3 * c, 3 * c + 3):
                cs += Jc[r, i] * cd[r] * Jc[r, j]
        M[i, j] = M[j, i] = s
        lhs[i, j] = lhs[j, i] = s + (h * damp[i] if i == j else 0.0) + h * cs
    return {"M": M, "lhs": lhs, "bias": bias, "tau": tau}


@pytest.mark.parametrize("state", ["standing", "feet_partly_lifted"])
def test_sparse_assembly_reproduces_dense_terms(state):
    """Standing: all 8 contact points 1 mm into the ground. Partly lifted:
    joint angles and velocities perturbed (seed 5), four points off the
    ground, whose rows the kernel skips."""
    m = _model("h1")
    rng = np.random.default_rng(5)
    x = standing_state(m)
    if state == "feet_partly_lifted":
        x = x.clone()
        x[7:m.nq] += torch.as_tensor(rng.normal(0, 0.15, m.nq - 7))
        x[m.nq:] += torch.as_tensor(rng.normal(0, 0.3, m.nv))
    u = torch.as_tensor(rng.normal(0, 3.0, m.nu))
    dense, parts = _dense_terms(m, x, u)
    assert int(parts["act"].sum()) == {"standing": 8, "feet_partly_lifted": 4}[state]
    got = _sparse_assembly(m, step_lists(m), parts, u.numpy())
    for k in dense:
        np.testing.assert_allclose(got[k], dense[k], rtol=0, atol=1e-12, err_msg=k)
