// Layout of the packed model (mpc_ilqr_tpu_torch/ops/step_plan.py).
//
// The int32 buffer opens with PI_HEADER_LEN entries: the dims, then the
// offset of every int array (into the int buffer) and of every float array
// (into the float32 buffer). The order of this enum is the order of
// INT_HEADER in step_plan.py; a CPU test holds the two against each other.
#pragma once

constexpr int kWarp = 32;
// Threads of the block that runs one chain: warp 0 runs the serial phases,
// all of them the bulky ones (step_plan.THREADS).
constexpr int kThreads = 128;

enum PlanInt {
  PI_B = 0,
  PI_NQ,
  PI_NV,
  PI_NU,
  PI_NCP,
  PI_NLEV,
  PI_FREE_QPOS,
  PI_FREE_DOF,
  PI_FREE_BODY,
  PI_N_JAC,        // Jacobian columns computed per step (length of jac_tgt)
  PI_I_PARENT,     // (B)   parent body, -1 = world
  PI_I_JTYPE,      // (B)   JointCode
  PI_I_QADR,       // (B)   first qpos of the body's joint
  PI_I_DADR,       // (B)   first dof of the body's joint
  PI_I_LEV_PTR,    // (nlev+1) start of each depth level in lev_body
  PI_I_LEV_BODY,   // (B)   bodies ordered by depth
  PI_I_CP_BODY,    // (ncp) body carrying each contact point
  PI_I_DOF_BODY,   // (nv)  body owning each dof
  PI_I_DOF_KIND,   // (nv)  DofKind
  PI_I_ANC_PTR,    // (B+1) per body, its ancestor dofs (anc_dof), ascending
  PI_I_ANC_DOF,
  PI_I_JAC_TGT,    // (n_jac) Jacobian column: body b, or contact point B + c
  PI_I_JAC_DOF,    // (n_jac) ... at dof k
  PI_I_MOV_PTR,    // (nv+1) per dof, the bodies it moves (mov_body), ascending
  PI_I_MOV_BODY,
  PI_I_MCP_PTR,    // (nv+1) per dof, the contact points it moves (mcp), ascending
  PI_I_MCP,
  PI_I_ACT_PTR,    // (nv+1) per dof, its actuators (act), ascending
  PI_I_ACT,
  PI_I_WORK_PTR,   // (kThreads+1) per thread, its assembly items (work): i*nv + j is
  PI_I_WORK,       //   the entry (i, j), i >= j, of M and the lhs; nv*nv + i the bias row i
  PI_F_BODY_POS,   // (B,3)
  PI_F_BODY_QUAT,  // (B,4) wxyz
  PI_F_BODY_IPOS,  // (B,3)
  PI_F_BODY_IQUAT, // (B,4)
  PI_F_BODY_MASS,  // (B)
  PI_F_BODY_INERTIA,  // (B,3) principal inertia
  PI_F_JNT_AXIS,   // (B,3)
  PI_F_JNT_POS,    // (B,3)
  PI_F_DOF_DAMPING,   // (nv)
  PI_F_DOF_ARMATURE,  // (nv)
  PI_F_ACT_GEAR,   // (nu)
  PI_F_GRAVITY,    // (3)
  PI_F_CP_POS,     // (ncp,3) contact points in body frame
  PI_F_CP_RADIUS,  // (ncp)
  PI_F_CONTACT,    // (4) stiffness, damping, friction, impratio
  PI_HEADER_LEN
};

enum JointCode { JC_FREE = 0, JC_HINGE = 1, JC_FIXED = 2 };
enum DofKind { DK_FREE_LIN = 0, DK_FREE_ANG = 1, DK_HINGE = 2 };

// The Cholesky factor: where one warp factors (nv <= kWarp), kWarp rows of
// kRowF floats, its columns below the diagonal the same way, and the
// columns' done stamps (kRowF ints); nv x nv otherwise.
constexpr int kRowF = 36;
__host__ __device__ inline int factor_floats(int nv) {
  return nv <= kWarp ? (2 * kWarp + 1) * kRowF : nv * nv;
}

// Floats of per-launch constants and per-step scratch the step needs in
// shared memory (step.cuh carves it in this order, from a 16-byte boundary).
__host__ __device__ inline int step_workspace_floats(int B, int nq, int nv, int nu, int ncp) {
  const int nx = nq + nv;
  return 3                  // alignment slack
       + factor_floats(nv) + nx  // F, dx (x − x̄ of the feedback law)
       + 9 * B + 9 * B      // Rq, Riq: rotations of body_quat, body_iquat
       + nx + nu            // x, u
       + 9 * B + 3 * B      // R, p
       + 3 * B + 9 * B      // pc, Rin
       + 3 * nv + 3 * nv + nv  // W, O, lin
       + 3 * 3 * B * nv     // Jv, Jw, G
       + 5 * 3 * B          // omega, alpha, acc, fb, nb
       + 2 * nv * nv        // M, L (lhs)
       + 4 * nv             // bias, tau, rhs, vn
       + 3 * ncp + 3 * ncp * nv + 3 * 3 * ncp + ncp;  // pw, Jc, vel, cd, fel, act
}
