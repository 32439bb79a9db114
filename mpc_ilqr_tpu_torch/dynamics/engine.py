"""Rigid-body dynamics on tensors: the semi-implicit MuJoCo-Euler step.

- `mass_matrix`   composite M(q) from body Jacobians
- `bias_forces`   Coriolis/centrifugal/gravity by a level-batched RNEA
- `contact_terms` smooth compliant point contact vs. the ground plane,
                  integrated implicitly
- `step`          x_{t+1} = f(x_t, u_t) with implicit joint damping
- `step_and_jac`  (x_next, A, B) grouped by input block
- `gravity_comp`  actuator torques cancelling the bias at a state
- `contact_forces` the diagnostic f_el − C·(J v) at the contact points

One forward-kinematics pass per step feeds M, the bias and the contact
geometry. Every function takes one state and composes with
`torch.func.vmap` / `jvp`; none writes in place.
"""
from __future__ import annotations

import functools

import torch
from torch.func import jvp, vmap

from mpc_ilqr_tpu_torch.dynamics import math as qm
from mpc_ilqr_tpu_torch.dynamics.kinematics import (
    KinFrames,
    _tree_levels,
    body_com_positions,
    body_jacobians,
    forward_kinematics,
    point_jacobians,
)
from mpc_ilqr_tpu_torch.models.robot import (
    JNT_BALL,
    JNT_FIXED,
    JNT_FREE,
    JNT_HINGE,
    JNT_SLIDE,
    RobotModel,
    static_tensor,
)
from mpc_ilqr_tpu_torch.ops import linalg


def _flat(J: torch.Tensor) -> torch.Tensor:
    """(..., B, 3, n) -> (..., B*3, n)."""
    return J.reshape(J.shape[:-3] + (-1, J.shape[-1]))


def normalize_state(model: RobotModel, x: torch.Tensor) -> torch.Tensor:
    """Normalize the free/ball-joint quaternions inside x."""
    pieces, at = [], 0
    for i in range(model.nbody):
        jt = model.body_jnt_type[i]
        if jt not in (JNT_FREE, JNT_BALL):
            continue
        a = model.body_qpos_adr[i] + (3 if jt == JNT_FREE else 0)
        pieces += [x[at:a], qm.quat_normalize(x[a : a + 4])]
        at = a + 4
    if not pieces:
        return x
    return torch.cat(pieces + [x[at:]])


def _principal_rotate(model: RobotModel, fr: KinFrames, vecs: torch.Tensor,
                      transpose: bool = False) -> torch.Tensor:
    """Apply Rin = fr.R @ R(iquat) (or its transpose) to a (B,3)/(B,3,n) batch."""
    Ri = qm.quat_to_mat(model.body_iquat)
    v = vecs if vecs.dim() == 3 else vecs[..., None]
    if transpose:  # Rinᵀ v = Riᵀ (fr.Rᵀ v)
        out = torch.matmul(Ri.transpose(-1, -2), torch.matmul(fr.R.transpose(-1, -2), v))
    else:  # Rin v = fr.R (Ri v)
        out = torch.matmul(fr.R, torch.matmul(Ri, v))
    return out if vecs.dim() == 3 else out[..., 0]


def _apply_world_inertia(model: RobotModel, fr: KinFrames, vecs: torch.Tensor) -> torch.Tensor:
    """Iw @ v per body via Iw = Rin diag(I) Rinᵀ, (B,3)->(B,3)."""
    loc = _principal_rotate(model, fr, vecs, transpose=True)
    return _principal_rotate(model, fr, model.body_inertia * loc)


def _body_accelerations(model: RobotModel, fr: KinFrames, v: torch.Tensor, omega, pc):
    """Velocity-product body accelerations (α_i, a_ci) at zero v̇: the RNEA
    outward recursion, one batch per tree level.

    World frame, body i with parent p, world axis w, anchor o, rate q̇:
        hinge: α_i = α_p + (ω_p × w) q̇
        ball:  α_i = α_p + ω_p × (ω_i − ω_p)
        slide: α_i = α_p, plus the Coriolis term 2 ω_p × (w q̇)
        fixed: α_i = α_p
        a(x) = a_p(o) + α_i × (x − o) + ω_i × (ω_i × (x − o))
    Free base at constant qvel: α = 0, origin acceleration 0.
    """
    B = model.nbody
    zero3 = v.new_zeros(3)
    alpha = [zero3] * B
    a_c = [zero3] * B
    parent, dadr = model.body_parent, model.body_dof_adr

    for level in _tree_levels(model.body_parent, model.body_jnt_type):
        for i in level.get(JNT_FREE, ()):
            r = pc[i] - fr.p[i]
            a_c[i] = qm.cross(omega[i], qm.cross(omega[i], r))
        for jt in (JNT_BALL, JNT_HINGE, JNT_SLIDE, JNT_FIXED):
            gi = list(level.get(jt, ()))
            if not gi:
                continue
            # World-rooted bodies: the parent is the static world.
            root = [parent[i] < 0 for i in gi]
            om_p = torch.stack([zero3 if rt else omega[parent[i]] for i, rt in zip(gi, root)])
            al_p = torch.stack([zero3 if rt else alpha[parent[i]] for i, rt in zip(gi, root)])
            pc_p = torch.stack([zero3 if rt else pc[parent[i]] for i, rt in zip(gi, root)])
            ac_p = torch.stack([zero3 if rt else a_c[parent[i]] for i, rt in zip(gi, root)])
            g = static_tensor(gi, v.device)
            d = static_tensor([dadr[i] for i in gi], v.device)
            om_i = omega[g]
            coriolis = 0.0
            if jt == JNT_HINGE:
                o = fr.dof_anchor[d]
                al_i = al_p + qm.cross(om_p, fr.dof_axis[d]) * v[d][:, None]
            elif jt == JNT_BALL:
                o = fr.dof_anchor[d]
                al_i = al_p + qm.cross(om_p, om_i - om_p)
            elif jt == JNT_SLIDE:
                o = pc_p
                al_i = al_p
                coriolis = 2.0 * qm.cross(om_p, fr.dof_axis[d] * v[d][:, None])
            else:  # fixed: inherits the parent's motion; anchor = parent CoM
                o = pc_p
                al_i = al_p
            r_o = o - pc_p
            a_o = ac_p + qm.cross(al_p, r_o) + qm.cross(om_p, qm.cross(om_p, r_o))
            r_c = pc[g] - o
            a_ci = a_o + qm.cross(al_i, r_c) + qm.cross(om_i, qm.cross(om_i, r_c)) + coriolis
            for r, i in enumerate(gi):
                alpha[i] = al_i[r]
                a_c[i] = a_ci[r]
    return torch.stack(alpha), torch.stack(a_c)


def _frames_and_jacs(model: RobotModel, q: torch.Tensor):
    """The q-only kinematic pass shared by M, bias, and contact geometry."""
    fr = forward_kinematics(model, q)
    pc = body_com_positions(model, fr)
    Jv, Jw = body_jacobians(model, fr, pc)
    return fr, pc, _flat(Jv), Jw


def _mass_from(model: RobotModel, fr: KinFrames, Jv_f: torch.Tensor, Jw: torch.Tensor):
    """M(q) = Jvᵀ m Jv + Gᵀ diag(I) G + diag(armature), G = Rinᵀ Jw."""
    G = _principal_rotate(model, fr, Jw, transpose=True)  # (B,3,nv)
    Gd = model.body_inertia[:, :, None] * G
    mass3 = torch.repeat_interleave(model.body_mass, 3)[:, None]
    M = torch.matmul(Jv_f.T, Jv_f * mass3) + torch.matmul(_flat(G).T, _flat(Gd))
    return M + torch.diag(model.dof_armature)


def _bias_given(model: RobotModel, fr: KinFrames, pc, Jv_f, Jw_f, v: torch.Tensor):
    """bias(q, v) with the q-only kinematics precomputed."""
    omega = torch.matmul(Jw_f, v).reshape(-1, 3)
    alpha, acc_c = _body_accelerations(model, fr, v, omega, pc)
    f = model.body_mass[:, None] * (acc_c - model.gravity[None, :])
    n = _apply_world_inertia(model, fr, alpha) + qm.cross(
        omega, _apply_world_inertia(model, fr, omega))
    return torch.matmul(Jv_f.T, f.reshape(-1)) + torch.matmul(Jw_f.T, n.reshape(-1))


def _dynamics_terms(model: RobotModel, q: torch.Tensor, v: torch.Tensor):
    """Frames, M(q) and bias(q, v) from one FK pass."""
    fr, pc, Jv_f, Jw = _frames_and_jacs(model, q)
    M = _mass_from(model, fr, Jv_f, Jw)
    bias = _bias_given(model, fr, pc, Jv_f, _flat(Jw), v)
    return fr, M, bias


def mass_matrix(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """Joint-space inertia matrix M(q) + armature, shape (nv, nv)."""
    fr, pc, Jv_f, Jw = _frames_and_jacs(model, q)
    return _mass_from(model, fr, Jv_f, Jw)


def bias_forces(model: RobotModel, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """qfrc_bias: M(q) v̇ + bias(q, v) = tau."""
    return _dynamics_terms(model, q, v)[2]


def contact_geometry(model: RobotModel, fr: KinFrames):
    """The q-only half of contact: point placement, Jacobians, elastic
    normal force. Returns (Jp (ncp,3,nv), f_el (ncp,3), fn_el (ncp,),
    active (ncp,), pw (ncp,3))."""
    bidx = static_tensor(model.cp_body_idx, fr.p.device)
    pw = fr.p[bidx] + torch.matmul(fr.R[bidx], model.cp_pos[..., None])[..., 0]
    Jp = point_jacobians(model, fr, model.cp_body_idx, pw)
    # Penetration of the point's surface sphere into the z=0 plane.
    depth = model.cp_radius - pw[:, 2]
    active = (depth > 0.0).to(pw.dtype)
    fn_el = model.contact_stiffness * depth * active
    f_el = torch.cat([pw.new_zeros((fn_el.shape[0], 2)), fn_el[:, None]], dim=-1)
    return Jp, f_el, fn_el, active, pw


def contact_cdiag(model: RobotModel, Jp_f, fn_el, active, v: torch.Tensor, h):
    """The v-dependent half of contact: the implicit damping diagonal.

    Tangential: regularized Coulomb viscosity mu·fn/|v_t| with the
    stiction regularization 1e-6/impratio; normal: damping + h·stiffness.
    """
    vel = torch.matmul(Jp_f, v).reshape(-1, 3)
    vt = vel[:, :2]
    eps = 1e-6 / torch.clamp(model.contact_impratio, min=1e-3)
    vt_norm = torch.sqrt(torch.sum(vt * vt, dim=-1) + eps)
    ct = model.contact_friction * fn_el / vt_norm
    cn = model.contact_damping + h * model.contact_stiffness
    return torch.stack([ct, ct, cn.expand_as(ct)], dim=-1) * active[:, None]


def contact_terms(model: RobotModel, fr: KinFrames, v: torch.Tensor, h):
    """(Jp (ncp,3,nv), f_el (ncp,3), c_diag (ncp,3), points_w (ncp,3))."""
    if model.ncp == 0:
        z = v.new_zeros((0, 3))
        return v.new_zeros((0, 3, model.nv)), z, z, z
    Jp, f_el, fn_el, active, pw = contact_geometry(model, fr)
    return Jp, f_el, contact_cdiag(model, _flat(Jp), fn_el, active, v, h), pw


def contact_forces(model: RobotModel, x: torch.Tensor):
    """Diagnostic contact forces at state x: (forces (ncp,3), points (ncp,3)).

    Effective force f = f_el − C·(J v), what the integrator applies to first
    order (the contact-schedule generator's quantity)."""
    q, v = model.split_state(normalize_state(model, x))
    fr = forward_kinematics(model, q)
    Jp, f_el, c_diag, pw = contact_terms(model, fr, v, model.timestep)
    return f_el - c_diag * torch.matmul(Jp, v), pw


@functools.lru_cache(maxsize=32)
def _actuator_selection(act_dof_adr: tuple, nv: int) -> tuple:
    """The 0/1 (nv, nu) map of actuators onto their dofs."""
    return tuple(tuple(1.0 if d == r else 0.0 for d in act_dof_adr) for r in range(nv))


def _actuation_matrix(model: RobotModel, like: torch.Tensor) -> torch.Tensor:
    """S = ∂tau/∂u (nv, nu): the constant actuator scatter."""
    S = static_tensor(_actuator_selection(model.act_dof_adr, model.nv), like.device, like.dtype)
    return S * model.act_gear[None, :]


def applied_torques(model: RobotModel, u: torch.Tensor) -> torch.Tensor:
    """Scatter actuator commands into the dof-space torque vector."""
    return torch.matmul(_actuation_matrix(model, u), u)


@functools.lru_cache(maxsize=32)
def _integration_segments(body_jnt_type: tuple, body_qpos_adr: tuple, body_dof_adr: tuple):
    """The position update as segments in qpos order, and where the last
    ends: ("keep", a0, a1) copies q[a0:a1]; ("lin", a0, a1, d0) is
    q[a0:a1] + h v[d0:d0+a1-a0] (a free joint's position, or a run of
    hinge/slide joints with consecutive qpos and dof addresses); ("quat",
    a, d) integrates the quaternion at q[a:a+4] with the rate v[d:d+3]."""
    segs, at = [], 0
    for jt, a, d in zip(body_jnt_type, body_qpos_adr, body_dof_adr):
        if jt not in (JNT_FREE, JNT_BALL, JNT_HINGE, JNT_SLIDE):
            continue
        if a > at:
            segs.append(("keep", at, a))
        if jt == JNT_FREE:
            segs += [("lin", a, a + 3, d), ("quat", a + 3, d + 3)]
            at = a + 7
        elif jt == JNT_BALL:
            segs.append(("quat", a, d))
            at = a + 4
        else:
            last = segs[-1] if segs else None
            if last and last[0] == "lin" and last[2] == a and last[3] + a - last[1] == d:
                segs[-1] = ("lin", last[1], a + 1, last[3])
            else:
                segs.append(("lin", a, a + 1, d))
            at = a + 1
    return tuple(segs), at


def integrate_position(model: RobotModel, q: torch.Tensor, v_next: torch.Tensor, h) -> torch.Tensor:
    """Semi-implicit position update (uses the NEW velocity, like mj Euler)."""
    segs, end = _integration_segments(model.body_jnt_type, model.body_qpos_adr,
                                      model.body_dof_adr)
    pieces = []
    for seg in segs:
        if seg[0] == "keep":
            pieces.append(q[seg[1]:seg[2]])
        elif seg[0] == "lin":
            _, a0, a1, d0 = seg
            pieces.append(q[a0:a1] + h * v_next[d0:d0 + a1 - a0])
        else:
            _, a, d = seg
            pieces.append(qm.quat_integrate(q[a:a + 4], v_next[d:d + 3], h))
    return torch.cat(pieces + [q[end:]])


def _cholesky(lhs: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of lhs, all NaN where the factorization fails, as
    JAX's `cho_factor` gives it: a diverged line-search candidate then
    carries NaN to its cost and is rejected, instead of raising. No host
    sync (`torch.linalg.cholesky` checks its info on the host)."""
    L, info = torch.linalg.cholesky_ex(lhs)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))


def _cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(L Lᵀ)⁻¹ b for b (n,) or (n, m)."""
    if b.dim() == 1:
        return torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.cholesky_solve(b, L)


def step(model: RobotModel, x: torch.Tensor, u: torch.Tensor, n_substeps: int = 1,
         frozen_mass: bool = False, solver: str = "chol") -> torch.Tensor:
    """One control step x_{t+1} = f(x_t, u_t), n_substeps physics substeps of

        (M + h D + h Jᵀ C J) v' = M v + h (tau + Jᵀ f_el − bias),
        q' = integrate(q, v').

    frozen_mass=True detaches M(q): zero tangents through the inertia
    assembly under `jvp` (a linearization-only approximation; the values are
    unchanged). solver="chol" solves for v' with the factored Cholesky (the
    form to differentiate); "masked" with ops/linalg.spd_solve, the unrolled
    masked solve, for plain rollouts only."""
    if solver not in ("chol", "masked"):
        raise ValueError(f"engine.step solver must be 'chol' or 'masked', got {solver!r}")
    h = model.timestep / n_substeps
    for _ in range(n_substeps):
        q, v = model.split_state(normalize_state(model, x))
        fr, M, bias = _dynamics_terms(model, q, v)
        if frozen_mass:
            M = M.detach()
        tau = applied_torques(model, u)
        Jp, f_el, c_diag, _ = contact_terms(model, fr, v, h)
        lhs = M + h * torch.diag(model.dof_damping)
        if model.ncp:
            Jp_f = _flat(Jp)
            lhs = lhs + h * torch.matmul(Jp_f.T, Jp_f * c_diag.reshape(-1)[:, None])
            tau = tau + torch.matmul(Jp_f.T, f_el.reshape(-1))
        rhs = torch.matmul(M, v) + h * (tau - bias)
        if solver == "masked":
            v_next = linalg.spd_solve(lhs, rhs)
        else:
            v_next = _cho_solve(_cholesky(lhs), rhs)
        x = torch.cat([integrate_position(model, q, v_next, h), v_next])
    return x


def step_and_jac(model: RobotModel, x: torch.Tensor, u: torch.Tensor,
                 n_substeps: int = 1, frozen_mass: bool = False, q_chunk: int = 0):
    """(x_next, A, B): the step Jacobians, grouped by input block.

      - u-block: tau is linear in u and the lhs does not depend on u, so
        ∂v'/∂u = h L⁻¹ S (one extra solve, no tangents).
      - v-block: FK, M(q) and the contact geometry do not depend on v, so
        the nv tangents run only through the RNEA bias and the stiction
        viscosity c(v), sharing the one factorization of L.
      - q-block: a full jvp through the substep for the nq directions
        (frozen_mass honoured as in `step`), in groups of q_chunk one
        after another when 0 < q_chunk < nq (cfg.lin_chunk).
    """
    h = model.timestep / n_substeps
    nq, nv = model.nq, model.nv
    S = _actuation_matrix(model, x)
    I_v = torch.eye(nv, dtype=x.dtype, device=x.device)
    E_q = torch.eye(model.nx, dtype=x.dtype, device=x.device)[:nq]
    m_sub = model if n_substeps == 1 else model.replace(timestep=h)

    def sub_jac(x):
        q, v = model.split_state(normalize_state(model, x))
        fr, pc, Jv_f, Jw = _frames_and_jacs(model, q)
        M = _mass_from(model, fr, Jv_f, Jw)
        Jw_f = _flat(Jw)
        bias = _bias_given(model, fr, pc, Jv_f, Jw_f, v)
        tau = applied_torques(model, u)
        lhs = M + h * torch.diag(model.dof_damping)
        if model.ncp:
            Jp, f_el, fn_el, active, _ = contact_geometry(model, fr)
            Jp_f = _flat(Jp)
            c_diag = contact_cdiag(model, Jp_f, fn_el, active, v, h)
            lhs = lhs + h * torch.matmul(Jp_f.T, Jp_f * c_diag.reshape(-1)[:, None])
            tau = tau + torch.matmul(Jp_f.T, f_el.reshape(-1))
        rhs = torch.matmul(M, v) + h * (tau - bias)
        L = _cholesky(lhs)
        v_next = _cho_solve(L, rhs)
        x_next = torch.cat([integrate_position(model, q, v_next, h), v_next])

        # u-block: δv' = h L⁻¹ S
        dv_u = h * _cho_solve(L, S)

        # v-block: δr = M δv − h δbias, δL v' = h Jᵀ(δc ⊙ J v')
        def bias_c(v_):
            b = _bias_given(model, fr, pc, Jv_f, Jw_f, v_)
            c = (contact_cdiag(model, Jp_f, fn_el, active, v_, h)
                 if model.ncp else v_.new_zeros((0, 3)))
            return b, c

        db, dc = vmap(lambda e: jvp(bias_c, (v,), (e,))[1])(I_v)
        R_v = M.T - h * db  # rows = directions
        if model.ncp:
            w = torch.matmul(Jp_f, v_next)
            R_v = R_v - h * torch.matmul(dc.reshape(nv, -1) * w[None, :], Jp_f)
        dv_v = _cho_solve(L, R_v.T)  # (nv, nv), columns = directions

        # q-block: full jvp, nq directions.
        f_q = lambda x_: step(m_sub, x_, u, 1, frozen_mass)
        c = q_chunk if 0 < q_chunk < nq else nq
        dq_full = torch.cat([vmap(lambda e: jvp(f_q, (x,), (e,))[1])(E)
                             for E in E_q.split(c)])  # (nq, nx)

        # ∂q'/∂v': the q-rows of the v and u columns.
        g = lambda w_: integrate_position(model, q, w_, h)
        Gv = vmap(lambda e: jvp(g, (v_next,), (e,))[1])(I_v)  # (nv, nq)

        A = torch.cat([dq_full.T, torch.cat([torch.matmul(Gv.T, dv_v), dv_v], dim=0)], dim=1)
        B = torch.cat([torch.matmul(Gv.T, dv_u), dv_u], dim=0)
        return x_next, A, B

    x_k, A, B = sub_jac(x)
    for _ in range(n_substeps - 1):  # compose: A←A_k A, B←A_k B + B_k
        x_k, A_k, B_k = sub_jac(x_k)
        A = torch.matmul(A_k, A)
        B = torch.matmul(A_k, B) + B_k
    return x_k, A, B


def gravity_comp(model: RobotModel, x: torch.Tensor) -> torch.Tensor:
    """Actuator torques cancelling qfrc_bias at the current state."""
    q, v = model.split_state(normalize_state(model, x))
    return bias_forces(model, q, v)[static_tensor(model.act_dof_adr, x.device)] / model.act_gear
