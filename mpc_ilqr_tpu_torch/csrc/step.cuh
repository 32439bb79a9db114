// One semi-implicit dynamics step of engine.step, run by one block of
// kThreads threads (four warps).
//
//   (M + h D + h Jᵀ C J) v' = M v + h (tau + Jᵀ f_el − bias),   q' = integrate(q, v')
//
// The chain is bound by latency (rollout.cu): a step is a sequence of short
// dependent phases. The serial ones run in warp 0, separated by
// __syncwarp(): FK and RNEA level by level, body forces and the contact law,
// the Cholesky factor (lane i on row i, one column per pass), integration.
// The bulky ones run on the whole block: per-dof world axes / anchors, CoMs,
// inertial frames and contact points; Jacobian columns at ancestor dofs
// only; body angular and contact-point velocities; M, the lhs, the bias and
// tau over the plan's lists, dealt to the threads by the plan. A named
// barrier over the block's threads (chain_sync) closes each of these six
// block phases. Warp 1 forms rhs and runs the forward substitution a column
// behind warp 0's factor (column stamps in shared memory), then the back
// substitution. No block barrier sits inside the factor or the
// substitutions. Larger models (nv > 32) solve in warp 0 over shared memory.
//
// Every sum keeps the order of the dense formulation: M, the lhs, the bias
// and the velocities over the plan's ascending lists (the terms skipped are
// exact zeros: a dof that does not move the body, a contact point off the
// ground), each entry of M in both operand orders (M_ij for the factor's
// input, M_ji for rhs), the factor in a right-looking factorization's update
// order, the substitutions in warp_sum's pairwise order. So the step gives
// the dense formulation's bits for finite states; the accuracy of a float32
// chain at its kernel tolerance rests on that. The tree is indexed directly
// (parent and address arrays), not through the one-hot matrices the TPU
// kernel needed.
#pragma once
#include "step_layout.cuh"

constexpr unsigned kFull = 0xffffffffu;

struct Model {
  int B, nq, nv, nu, ncp, nlev, free_qpos, free_dof, free_body, n_jac;
  const int *parent, *jtype, *qadr, *dadr, *lev_ptr, *lev_body, *cp_body, *dof_body, *dof_kind,
      *anc_ptr, *anc_dof, *jac_tgt, *jac_dof, *mov_ptr, *mov_body, *mcp_ptr, *mcp, *act_ptr, *act,
      *work_ptr, *work;
  const float *body_pos, *body_quat, *body_ipos, *body_iquat, *body_mass, *body_inertia,
      *jnt_axis, *jnt_pos, *dof_damping, *dof_armature, *act_gear, *gravity, *cp_pos,
      *cp_radius, *contact;
};

struct Work {
  float *Rq, *Riq, *x, *u, *R, *p, *pc, *Rin, *W, *O, *lin, *Jv, *Jw, *G, *omega, *alpha, *acc,
      *fb, *nb, *M, *L, *F, *FC, *dx, *bias, *tau, *rhs, *vn, *pw, *Jc, *vel, *cd, *fel, *act;
  int* done;  // the factor's column stamps (nv <= kWarp)
};

__device__ inline Model bind_model(const int* mi, const float* mf) {
  Model m;
  m.B = mi[PI_B]; m.nq = mi[PI_NQ]; m.nv = mi[PI_NV]; m.nu = mi[PI_NU]; m.ncp = mi[PI_NCP];
  m.nlev = mi[PI_NLEV]; m.free_qpos = mi[PI_FREE_QPOS]; m.free_dof = mi[PI_FREE_DOF];
  m.free_body = mi[PI_FREE_BODY]; m.n_jac = mi[PI_N_JAC];
  m.parent = mi + mi[PI_I_PARENT]; m.jtype = mi + mi[PI_I_JTYPE];
  m.qadr = mi + mi[PI_I_QADR]; m.dadr = mi + mi[PI_I_DADR];
  m.lev_ptr = mi + mi[PI_I_LEV_PTR]; m.lev_body = mi + mi[PI_I_LEV_BODY];
  m.cp_body = mi + mi[PI_I_CP_BODY];
  m.dof_body = mi + mi[PI_I_DOF_BODY]; m.dof_kind = mi + mi[PI_I_DOF_KIND];
  m.anc_ptr = mi + mi[PI_I_ANC_PTR]; m.anc_dof = mi + mi[PI_I_ANC_DOF];
  m.jac_tgt = mi + mi[PI_I_JAC_TGT]; m.jac_dof = mi + mi[PI_I_JAC_DOF];
  m.mov_ptr = mi + mi[PI_I_MOV_PTR]; m.mov_body = mi + mi[PI_I_MOV_BODY];
  m.mcp_ptr = mi + mi[PI_I_MCP_PTR]; m.mcp = mi + mi[PI_I_MCP];
  m.act_ptr = mi + mi[PI_I_ACT_PTR]; m.act = mi + mi[PI_I_ACT];
  m.work_ptr = mi + mi[PI_I_WORK_PTR]; m.work = mi + mi[PI_I_WORK];
  m.body_pos = mf + mi[PI_F_BODY_POS]; m.body_quat = mf + mi[PI_F_BODY_QUAT];
  m.body_ipos = mf + mi[PI_F_BODY_IPOS]; m.body_iquat = mf + mi[PI_F_BODY_IQUAT];
  m.body_mass = mf + mi[PI_F_BODY_MASS]; m.body_inertia = mf + mi[PI_F_BODY_INERTIA];
  m.jnt_axis = mf + mi[PI_F_JNT_AXIS]; m.jnt_pos = mf + mi[PI_F_JNT_POS];
  m.dof_damping = mf + mi[PI_F_DOF_DAMPING]; m.dof_armature = mf + mi[PI_F_DOF_ARMATURE];
  m.act_gear = mf + mi[PI_F_ACT_GEAR];
  m.gravity = mf + mi[PI_F_GRAVITY]; m.cp_pos = mf + mi[PI_F_CP_POS];
  m.cp_radius = mf + mi[PI_F_CP_RADIUS]; m.contact = mf + mi[PI_F_CONTACT];
  return m;
}

// Carves the workspace in the order step_workspace_floats counts it, from
// the first 16-byte boundary at or after s0 (F is read as float4).
__device__ inline Work carve(float* s0, const Model& m) {
  const int B = m.B, nv = m.nv, ncp = m.ncp;
  // An offset from s0, not an integer round trip, so the compiler still sees
  // shared-memory pointers (ld.shared, not generic loads).
  float* s = s0 + ((4u - static_cast<unsigned>(__cvta_generic_to_shared(s0)) / 4u % 4u) % 4u);
  Work w;
  w.F = s;  // nv <= kWarp: rows, then columns below the diagonal (FC), then done
  w.FC = s + kWarp * kRowF;
  w.done = reinterpret_cast<int*>(s + 2 * kWarp * kRowF);
  s += factor_floats(nv);
  w.dx = s; s += m.nq + nv;
  w.Rq = s; s += 9 * B;
  w.Riq = s; s += 9 * B;
  w.x = s; s += m.nq + nv;
  w.u = s; s += m.nu;
  w.R = s; s += 9 * B;
  w.p = s; s += 3 * B;
  w.pc = s; s += 3 * B;
  w.Rin = s; s += 9 * B;
  w.W = s; s += 3 * nv;
  w.O = s; s += 3 * nv;
  w.lin = s; s += nv;
  w.Jv = s; s += 3 * B * nv;
  w.Jw = s; s += 3 * B * nv;
  w.G = s; s += 3 * B * nv;
  w.omega = s; s += 3 * B;
  w.alpha = s; s += 3 * B;
  w.acc = s; s += 3 * B;
  w.fb = s; s += 3 * B;
  w.nb = s; s += 3 * B;
  w.M = s; s += nv * nv;
  w.L = s; s += nv * nv;
  w.bias = s; s += nv;
  w.tau = s; s += nv;
  w.rhs = s; s += nv;
  w.vn = s; s += nv;
  w.pw = s; s += 3 * ncp;
  w.Jc = s; s += 3 * ncp * nv;
  w.vel = s; s += 3 * ncp;
  w.cd = s; s += 3 * ncp;
  w.fel = s; s += 3 * ncp;
  w.act = s; s += ncp;
  return w;
}

// ---- 3-vector / 3x3 helpers (row-major) ----
__device__ inline void quat_to_mat(const float* q, float* R) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = 1.f - 2.f * (y * y + z * z); R[1] = 2.f * (x * y - w * z); R[2] = 2.f * (x * z + w * y);
  R[3] = 2.f * (x * y + w * z); R[4] = 1.f - 2.f * (x * x + z * z); R[5] = 2.f * (y * z - w * x);
  R[6] = 2.f * (x * z - w * y); R[7] = 2.f * (y * z + w * x); R[8] = 1.f - 2.f * (x * x + y * y);
}
__device__ inline void mat3mul(const float* A, const float* B, float* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}
__device__ inline void mv3(const float* A, const float* v, float* o) {
  for (int i = 0; i < 3; ++i) o[i] = A[3 * i] * v[0] + A[3 * i + 1] * v[1] + A[3 * i + 2] * v[2];
}
__device__ inline void mtv3(const float* A, const float* v, float* o) {
  for (int i = 0; i < 3; ++i) o[i] = A[i] * v[0] + A[3 + i] * v[1] + A[6 + i] * v[2];
}
__device__ inline void cross3(const float* a, const float* b, float* o) {
  const float o0 = a[1] * b[2] - a[2] * b[1];
  const float o1 = a[2] * b[0] - a[0] * b[2];
  const float o2 = a[0] * b[1] - a[1] * b[0];
  o[0] = o0; o[1] = o1; o[2] = o2;
}
__device__ inline void quat_normalize(const float* q, float* o) {
  const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3] + 1e-12f);
  for (int k = 0; k < 4; ++k) o[k] = q[k] / n;
}
// Iw v = Rin diag(I) Rinᵀ v
__device__ inline void world_inertia(const float* Rin, const float* I, const float* v, float* o) {
  float loc[3];
  mtv3(Rin, v, loc);
  for (int k = 0; k < 3; ++k) loc[k] *= I[k];
  mv3(Rin, loc, o);
}

// The block's threads meet here (named barrier 1): the end of a block phase.
__device__ inline void chain_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"r"(kThreads) : "memory");
}
// A column's done stamp: written with release order by warp 0's lane 0 once
// the column is in shared memory, read with acquire order by warp 1.
__device__ inline void store_release(int* p, int v) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("st.release.cta.shared::cta.u32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}
__device__ inline int load_acquire(const int* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  int v;
  asm volatile("ld.acquire.cta.shared::cta.u32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}
// Warps 0 and 1 meet here (named barrier 3): v' is in w.vn.
__device__ inline void solve_sync() {
  asm volatile("bar.sync 3, %0;\n" ::"r"(2 * kWarp) : "memory");
}

// Once per launch: the rotations of the constant body and inertial-frame
// quaternions, and M and the lhs zeroed (the step writes only their
// structurally non-zero entries; the rest stay zero).
__device__ void init_work(const Model& m, const Work& w) {
  for (int b = threadIdx.x; b < m.B; b += kThreads) {
    quat_to_mat(m.body_quat + 4 * b, w.Rq + 9 * b);
    quat_to_mat(m.body_iquat + 4 * b, w.Riq + 9 * b);
  }
  for (int i = threadIdx.x; i < m.nv * m.nv; i += kThreads) w.M[i] = w.L[i] = 0.f;
  if (m.nv <= kWarp)
    for (int i = threadIdx.x; i < kWarp; i += kThreads) w.done[i] = 0;
  chain_sync();
}

__device__ inline float warp_sum(float s) {
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

// rhs = M v + h (tau − bias), lane i on row i (one warp).
__device__ void form_rhs(const Model& m, const Work& w, float h) {
  const float* v = w.x + m.nq;
  for (int i = threadIdx.x & (kWarp - 1); i < m.nv; i += kWarp) {
    float s = 0.f;
    for (int j = 0; j < m.nv; ++j) s += w.M[i * m.nv + j] * v[j];
    w.rhs[i] = s + h * (w.tau[i] - w.bias[i]);
  }
}

// nv <= kWarp: warp 0 factors L Lᵀ = lhs while warp 1 forms rhs and
// solves L y = rhs a row behind it, then Lᵀ v' = y (v' to w.vn).
//
// The factor (warp 0) is left-looking, one column per pass with lane i on
// row i: s_i = lhs_ik − Σ_{p<k} L_ip L_kp in ascending p (the order in
// which a right-looking factorization updates the entry, so the factor is
// the same), every lane forming the pivot s_k too, L_ik = s_i / sqrt(s_k).
// The rows live in w.F, kRowF floats apart, and start at zero, so the dot
// products run in float4 chunks over the finished columns; kRowF = 36 puts
// eight consecutive rows on eight different bank quads (a stride of 32
// would put every row's chunk on the same four banks, 32-way conflicts). A
// copy of each column below the diagonal (FC) serves the back substitution.
// Column k done, lane 0 stamps done[k] with the step's epoch.
__device__ void factor_in_warp(const Model& m, const Work& w, int epoch) {
  const int lane = threadIdx.x, nv = m.nv;
  constexpr int Q = kRowF / 4;  // float4 per row
  const bool row = lane < nv;
  float4* F4 = reinterpret_cast<float4*>(w.F);
  float *F = w.F, *FC = w.FC;  // FC row k: L[k+1..][k]
#pragma unroll
  for (int q = 0; q < Q; ++q) F4[lane * Q + q] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();
  for (int k = 0; k < nv; ++k) {
    float s = (row && lane >= k) ? w.L[lane * nv + k] : 0.f, sk = w.L[k * nv + k];
    for (int q = 0; q < (k + 3) / 4; ++q) {
      const float4 a = F4[lane * Q + q], b = F4[k * Q + q];
      s -= a.x * b.x;
      s -= a.y * b.y;
      s -= a.z * b.z;
      s -= a.w * b.w;
      sk -= b.x * b.x;
      sk -= b.y * b.y;
      sk -= b.z * b.z;
      sk -= b.w * b.w;
    }
    const float d = sqrtf(sk);
    if (row && lane >= k) {
      const float l = lane == k ? d : s / d;
      F[lane * kRowF + k] = l;
      if (lane > k) FC[k * kRowF + lane - k - 1] = l;
    }
    __syncwarp();
    if (lane == 0) store_release(w.done + k, epoch);
  }
}

// Warp 1 (see factor_in_warp): row i of L y = rhs starts once column i of
// the factor is stamped. Each substitution row sums its terms across the
// lanes with warp_sum (term j on lane j going forward, term i + 1 + l on
// lane l going back: the order of the shared-memory version below), with
// every unknown in its lane's register (`mine`: y_j, then v'_j).
__device__ void substitute_in_warp(const Model& m, const Work& w, float h, int epoch) {
  const int lane = threadIdx.x & (kWarp - 1), nv = m.nv;
  const float *F = w.F, *FC = w.FC;
  form_rhs(m, w, h);
  __syncwarp();
  float mine = 0.f;
  for (int i = 0; i < nv; ++i) {
    while (load_acquire(w.done + i) != epoch) {
    }
    const float s = warp_sum(lane < i ? F[i * kRowF + lane] * mine : 0.f);
    const float yi = (w.rhs[i] - s) / F[i * kRowF + i];
    if (lane == i) mine = yi;
  }
  for (int i = nv - 1; i >= 0; --i) {  // term l = lane: L[i+1+l][i] v_{i+1+l}
    const int j = i + 1 + lane;
    const float vj = __shfl_sync(kFull, mine, j & (kWarp - 1));
    const float s = warp_sum(j < nv ? FC[i * kRowF + lane] * vj : 0.f);
    const float vi = (__shfl_sync(kFull, mine, i) - s) / F[i * kRowF + i];
    if (lane == i) mine = vi;
  }
  if (lane < nv) w.vn[lane] = mine;
}

// Warp 0, nv > kWarp: the factor right-looking over shared memory (w.F),
// two warp barriers per pivot; the substitutions as above, each unknown in
// shared memory, one warp barrier per row.
__device__ void solve_in_shared(const Model& m, const Work& w) {
  const int lane = threadIdx.x, nv = m.nv;
  float* F = w.F;
  for (int idx = lane; idx < nv * nv; idx += kWarp) F[idx] = w.L[idx];
  __syncwarp();
  for (int k = 0; k < nv; ++k) {
    const float d = sqrtf(F[k * nv + k]);
    for (int i = k + 1 + lane; i < nv; i += kWarp) F[i * nv + k] /= d;
    __syncwarp();
    if (lane == 0) F[k * nv + k] = d;
    const int r = nv - k - 1;
    for (int idx = lane; idx < r * r; idx += kWarp) {
      const int i = k + 1 + idx / r, j = k + 1 + idx % r;
      if (j <= i) F[i * nv + j] -= F[i * nv + k] * F[j * nv + k];
    }
    __syncwarp();
  }
  float* y = w.rhs;  // rhs becomes y in place, row by row
  for (int i = 0; i < nv; ++i) {
    float s = 0.f;
    for (int j = lane; j < i; j += kWarp) s += F[i * nv + j] * y[j];
    s = warp_sum(s);
    if (lane == 0) y[i] = (y[i] - s) / F[i * nv + i];
    __syncwarp();
  }
  for (int i = nv - 1; i >= 0; --i) {
    float s = 0.f;
    for (int j = i + 1 + lane; j < nv; j += kWarp) s += F[j * nv + i] * w.vn[j];
    s = warp_sum(s);
    if (lane == 0) w.vn[i] = (y[i] - s) / F[i * nv + i];
    __syncwarp();
  }
}

// Forward kinematics, one depth level per pass (warp 0).
__device__ void forward_kinematics(const Model& m, const Work& w) {
  const float* x = w.x;
  for (int lev = 0; lev < m.nlev; ++lev) {
    for (int k = m.lev_ptr[lev] + threadIdx.x; k < m.lev_ptr[lev + 1]; k += kWarp) {
      const int b = m.lev_body[k], par = m.parent[b], jt = m.jtype[b];
      float* Rb = w.R + 9 * b;
      float* pb = w.p + 3 * b;
      if (jt == JC_FREE) {
        const int a = m.qadr[b];
        float qn[4];
        quat_normalize(x + a + 3, qn);
        quat_to_mat(qn, Rb);
        for (int r = 0; r < 3; ++r) pb[r] = x[a + r];
        continue;
      }
      float Rp[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
      float pp[3] = {0.f, 0.f, 0.f};
      if (par >= 0) {
        for (int r = 0; r < 9; ++r) Rp[r] = w.R[9 * par + r];
        for (int r = 0; r < 3; ++r) pp[r] = w.p[3 * par + r];
      }
      float Ri[9], t[3];
      mat3mul(Rp, w.Rq + 9 * b, Ri);
      mv3(Rp, m.body_pos + 3 * b, t);
      float pi[3] = {pp[0] + t[0], pp[1] + t[1], pp[2] + t[2]};
      if (jt == JC_HINGE) {
        float s, c;
        sincosf(0.5f * x[m.qadr[b]], &s, &c);
        const float* ax = m.jnt_axis + 3 * b;
        const float* jp = m.jnt_pos + 3 * b;
        const float qj[4] = {c, s * ax[0], s * ax[1], s * ax[2]};
        float Rj[9], rj[3], d[3];
        quat_to_mat(qj, Rj);
        mv3(Rj, jp, rj);
        for (int r = 0; r < 3; ++r) d[r] = jp[r] - rj[r];
        mv3(Ri, d, t);
        for (int r = 0; r < 3; ++r) pi[r] += t[r];
        mat3mul(Ri, Rj, Rb);
      } else {
        for (int r = 0; r < 9; ++r) Rb[r] = Ri[r];
      }
      for (int r = 0; r < 3; ++r) pb[r] = pi[r];
    }
    __syncwarp();
  }
}

// RNEA outward recursion (velocity-product accelerations at zero v̇), one
// depth level per pass (warp 0).
__device__ void rnea(const Model& m, const Work& w) {
  const float* v = w.x + m.nq;
  for (int lev = 0; lev < m.nlev; ++lev) {
    for (int k = m.lev_ptr[lev] + threadIdx.x; k < m.lev_ptr[lev + 1]; k += kWarp) {
      const int b = m.lev_body[k], par = m.parent[b], jt = m.jtype[b];
      const float* om = w.omega + 3 * b;
      float* al = w.alpha + 3 * b;
      float* ac = w.acc + 3 * b;
      if (jt == JC_FREE) {
        float r[3], t[3];
        for (int i = 0; i < 3; ++i) { r[i] = w.pc[3 * b + i] - w.p[3 * b + i]; al[i] = 0.f; }
        cross3(om, r, t);
        cross3(om, t, ac);
        continue;
      }
      float om_p[3] = {0.f, 0.f, 0.f}, al_p[3] = {0.f, 0.f, 0.f};
      float pc_p[3] = {0.f, 0.f, 0.f}, ac_p[3] = {0.f, 0.f, 0.f};
      if (par >= 0) {
        for (int i = 0; i < 3; ++i) {
          om_p[i] = w.omega[3 * par + i]; al_p[i] = w.alpha[3 * par + i];
          pc_p[i] = w.pc[3 * par + i]; ac_p[i] = w.acc[3 * par + i];
        }
      }
      float o[3], al_i[3], t[3], t2[3];
      if (jt == JC_HINGE) {
        const int d = m.dadr[b];
        cross3(om_p, w.W + 3 * d, t);
        for (int i = 0; i < 3; ++i) { o[i] = w.O[3 * d + i]; al_i[i] = al_p[i] + t[i] * v[d]; }
      } else {
        for (int i = 0; i < 3; ++i) { o[i] = pc_p[i]; al_i[i] = al_p[i]; }
      }
      float r_o[3], a_o[3], r_c[3];
      for (int i = 0; i < 3; ++i) r_o[i] = o[i] - pc_p[i];
      cross3(al_p, r_o, t);
      cross3(om_p, r_o, t2);
      cross3(om_p, t2, t2);
      for (int i = 0; i < 3; ++i) a_o[i] = ac_p[i] + t[i] + t2[i];
      for (int i = 0; i < 3; ++i) r_c[i] = w.pc[3 * b + i] - o[i];
      cross3(al_i, r_c, t);
      cross3(om, r_c, t2);
      cross3(om, t2, t2);
      for (int i = 0; i < 3; ++i) { ac[i] = a_o[i] + t[i] + t2[i]; al[i] = al_i[i]; }
    }
    __syncwarp();
  }
}

// The contact damping diagonal, elastic force and activity of every
// contact point (warp 0).
__device__ void contact_law(const Model& m, const Work& w, float h) {
  const float k_c = m.contact[0], d_c = m.contact[1], mu = m.contact[2];
  for (int c = threadIdx.x; c < m.ncp; c += kWarp) {
    const float depth = m.cp_radius[c] - w.pw[3 * c + 2];
    const float active = depth > 0.f ? 1.f : 0.f;
    const float fn = k_c * depth * active;
    const float vx = w.vel[3 * c], vy = w.vel[3 * c + 1];
    const float eps = 1e-6f / fmaxf(m.contact[3], 1e-3f);
    const float ct = mu * fn / sqrtf(vx * vx + vy * vy + eps);
    const float cn = d_c + h * k_c;
    w.cd[3 * c] = ct * active; w.cd[3 * c + 1] = ct * active; w.cd[3 * c + 2] = cn * active;
    w.fel[3 * c] = 0.f; w.fel[3 * c + 1] = 0.f; w.fel[3 * c + 2] = fn;
    w.act[c] = active;
  }
}

// Body forces and torques from the RNEA accelerations (warp 0).
__device__ void body_forces(const Model& m, const Work& w) {
  for (int b = threadIdx.x; b < m.B; b += kWarp) {
    const float mb = m.body_mass[b];
    const float* Rin = w.Rin + 9 * b;
    const float* I = m.body_inertia + 3 * b;
    float ia[3], iw[3], t[3];
    for (int i = 0; i < 3; ++i) w.fb[3 * b + i] = mb * (w.acc[3 * b + i] - m.gravity[i]);
    world_inertia(Rin, I, w.alpha + 3 * b, ia);
    world_inertia(Rin, I, w.omega + 3 * b, iw);
    cross3(w.omega + 3 * b, iw, t);
    for (int i = 0; i < 3; ++i) w.nb[3 * b + i] = ia[i] + t[i];
  }
}

// This thread's share of the assembly (the plan's work list): entries
// (i, j), i >= j, of M and lhs = M + h D + h Jcᵀ C Jc, summed over the bodies
// dof i moves and its contact points on the ground (item i·nv + j); rows i
// of bias = Jvᵀ f + Jwᵀ n and tau = S gear u + Jcᵀ f_el, f_el having its
// normal row only (item nv·nv + i).
__device__ void assemble(const Model& m, const Work& w, float h, const float* u) {
  const int tid = threadIdx.x, nv = m.nv;
  for (int q = m.work_ptr[tid]; q < m.work_ptr[tid + 1]; ++q) {
    const int item = m.work[q];
    if (item < nv * nv) {
      const int i = item / nv, j = item - i * nv;
      float s = 0.f, su = 0.f;  // M_ij and M_ji, each in its own operand order
#pragma unroll 4
      for (int e = m.mov_ptr[i]; e < m.mov_ptr[i + 1]; ++e) {
        const int b = m.mov_body[e];
        const float mb = m.body_mass[b];
        const float* I = m.body_inertia + 3 * b;
        for (int r = 0; r < 3; ++r) {
          const int row = (3 * b + r) * nv;
          const float vi = w.Jv[row + i], vj = w.Jv[row + j], gi = w.G[row + i], gj = w.G[row + j];
          s += mb * vi * vj + gi * I[r] * gj;
          su += mb * vj * vi + gj * I[r] * gi;
        }
      }
      if (i == j) s += m.dof_armature[i];
      w.M[item] = s;
      if (i != j) w.M[j * nv + i] = su;
      float cs = 0.f;
      for (int e = m.mcp_ptr[i]; e < m.mcp_ptr[i + 1]; ++e) {
        const int c = m.mcp[e];
        if (w.act[c] == 0.f) continue;
        for (int r = 3 * c; r < 3 * c + 3; ++r) cs += w.Jc[r * nv + i] * w.cd[r] * w.Jc[r * nv + j];
      }
      w.L[item] = s + (i == j ? h * m.dof_damping[i] : 0.f) + h * cs;
    } else {
      const int i = item - nv * nv;
      float bs = 0.f;
#pragma unroll 4
      for (int e = m.mov_ptr[i]; e < m.mov_ptr[i + 1]; ++e) {
        const int b = m.mov_body[e];
        for (int r = 3 * b; r < 3 * b + 3; ++r)
          bs += w.Jv[r * nv + i] * w.fb[r] + w.Jw[r * nv + i] * w.nb[r];
      }
      float ts = 0.f;
      for (int e = m.act_ptr[i]; e < m.act_ptr[i + 1]; ++e) ts += m.act_gear[m.act[e]] * u[m.act[e]];
      float tc = 0.f;
      for (int e = m.mcp_ptr[i]; e < m.mcp_ptr[i + 1]; ++e) {
        const int c = m.mcp[e];
        if (w.act[c] != 0.f) tc += w.Jc[(3 * c + 2) * nv + i] * w.fel[3 * c + 2];
      }
      w.bias[i] = bs;
      w.tau[i] = ts + tc;
    }
  }
}

// Advances w.x (nq + nv floats in shared memory) by one substep of length h
// under the control u (nu floats in shared memory); epoch counts the
// launch's substeps from 1. Every thread of the block calls it; warp 0 has
// finished the step when it returns, the other warps return earlier (their
// next step starts by waiting for warp 0 at the first chain_sync).
__device__ void dyn_step(const Model& m, const Work& w, const float* u, float h, int epoch) {
  const int tid = threadIdx.x, lane = tid & (kWarp - 1);
  const bool warp0 = tid < kWarp;
  const int B = m.B, nq = m.nq, nv = m.nv, ncp = m.ncp;
  float* x = w.x;
  const float* v = x + nq;

  if (warp0) {
    // normalize_state: the free base quaternion
    if (lane == 0 && m.free_qpos >= 0) quat_normalize(x + m.free_qpos + 3, x + m.free_qpos + 3);
    __syncwarp();
    forward_kinematics(m, w);
  }
  chain_sync();

  // Per-dof world axes / anchors, body CoMs and inertial frames, contact points.
  for (int idx = tid; idx < nv + B + ncp; idx += kThreads) {
    if (idx < nv) {
      const int i = idx, kind = m.dof_kind[i], b = m.dof_body[i];
      const float* Rb = w.R + 9 * b;
      float* Wi = w.W + 3 * i;
      float* Oi = w.O + 3 * i;
      if (kind == DK_FREE_LIN) {
        const int k = i - m.free_dof;
        for (int r = 0; r < 3; ++r) { Wi[r] = (r == k) ? 1.f : 0.f; Oi[r] = 0.f; }
        w.lin[i] = 1.f;
      } else if (kind == DK_FREE_ANG) {
        const int k = i - m.free_dof - 3;
        for (int r = 0; r < 3; ++r) { Wi[r] = Rb[3 * r + k]; Oi[r] = w.p[3 * b + r]; }
        w.lin[i] = 0.f;
      } else {
        float t[3];
        mv3(Rb, m.jnt_axis + 3 * b, Wi);
        mv3(Rb, m.jnt_pos + 3 * b, t);
        for (int r = 0; r < 3; ++r) Oi[r] = w.p[3 * b + r] + t[r];
        w.lin[i] = 0.f;
      }
    } else if (idx < nv + B) {
      const int b = idx - nv;
      float t[3];
      mv3(w.R + 9 * b, m.body_ipos + 3 * b, t);
      for (int r = 0; r < 3; ++r) w.pc[3 * b + r] = w.p[3 * b + r] + t[r];
      mat3mul(w.R + 9 * b, w.Riq + 9 * b, w.Rin + 9 * b);
    } else {
      const int c = idx - nv - B, cb = m.cp_body[c];
      float t[3];
      mv3(w.R + 9 * cb, m.cp_pos + 3 * c, t);
      for (int r = 0; r < 3; ++r) w.pw[3 * c + r] = w.p[3 * cb + r] + t[r];
    }
  }
  chain_sync();

  // Jacobian columns at ancestor dofs only: Jv, Jw, G = Rinᵀ Jw (each
  // (B,3,nv)) of a body, Jc (ncp,3,nv) of a contact point. Entries off the
  // lists are never read.
  for (int idx = tid; idx < m.n_jac; idx += kThreads) {
    const int tgt = m.jac_tgt[idx], k = m.jac_dof[idx];
    const float* Wk = w.W + 3 * k;
    const bool lin = w.lin[k] != 0.f;
    if (tgt < B) {
      const int b = tgt;
      float jv[3], jw[3], g[3];
      if (lin) {
        for (int r = 0; r < 3; ++r) { jv[r] = Wk[r]; jw[r] = 0.f; }
      } else {
        float d[3];
        for (int r = 0; r < 3; ++r) d[r] = w.pc[3 * b + r] - w.O[3 * k + r];
        cross3(Wk, d, jv);
        for (int r = 0; r < 3; ++r) jw[r] = Wk[r];
      }
      mtv3(w.Rin + 9 * b, jw, g);
      for (int r = 0; r < 3; ++r) {
        w.Jv[(3 * b + r) * nv + k] = jv[r];
        w.Jw[(3 * b + r) * nv + k] = jw[r];
        w.G[(3 * b + r) * nv + k] = g[r];
      }
    } else {
      const int c = tgt - B;
      float col[3];
      if (lin) {
        for (int r = 0; r < 3; ++r) col[r] = Wk[r];
      } else {
        float d[3];
        for (int r = 0; r < 3; ++r) d[r] = w.pw[3 * c + r] - w.O[3 * k + r];
        cross3(Wk, d, col);
      }
      for (int r = 0; r < 3; ++r) w.Jc[(3 * c + r) * nv + k] = col[r];
    }
  }
  chain_sync();

  // Body angular velocities and contact-point velocities.
  for (int idx = tid; idx < 3 * B + 3 * ncp; idx += kThreads) {
    const bool body = idx < 3 * B;
    const int b = body ? idx / 3 : m.cp_body[(idx - 3 * B) / 3];
    const float* row = body ? w.Jw + idx * nv : w.Jc + (idx - 3 * B) * nv;
    float s = 0.f;
#pragma unroll 4
    for (int q = m.anc_ptr[b]; q < m.anc_ptr[b + 1]; ++q) {
      const int k = m.anc_dof[q];
      s += row[k] * v[k];
    }
    if (body) w.omega[idx] = s; else w.vel[idx - 3 * B] = s;
  }
  chain_sync();

  if (warp0) {
    rnea(m, w);
    body_forces(m, w);
    contact_law(m, w, h);
  }
  chain_sync();
  assemble(m, w, h, u);
  chain_sync();

  // v': warp 0 factors, warp 1 substitutes behind it (nv <= kWarp); larger
  // models solve in warp 0 over shared memory. Warps 2 and 3 are done.
  if (tid >= 2 * kWarp) return;
  if (nv <= kWarp) {
    if (warp0) {
      factor_in_warp(m, w, epoch);
    } else {
      substitute_in_warp(m, w, h, epoch);
    }
    solve_sync();
    if (!warp0) return;
  } else {
    if (!warp0) return;
    form_rhs(m, w, h);
    __syncwarp();
    solve_in_shared(m, w);
    __syncwarp();
  }

  // Semi-implicit integration with the new velocity.
  for (int b = lane; b < B; b += kWarp) {
    const int jt = m.jtype[b];
    if (jt == JC_HINGE) {
      x[m.qadr[b]] += h * w.vn[m.dadr[b]];
    } else if (jt == JC_FREE) {
      const int a = m.qadr[b], d = m.dadr[b];
      for (int r = 0; r < 3; ++r) x[a + r] += h * w.vn[d + r];
      // q' = normalize(q ⊗ exp(h ω)), series-safe exp at 0
      float phi[3], e[4], qn[4];
      for (int r = 0; r < 3; ++r) phi[r] = w.vn[d + 3 + r] * h;
      const float th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
      const float th = sqrtf(th2 + 1e-24f);
      const float kk = th2 < 1e-12f ? 0.5f - th2 / 48.f : sinf(0.5f * th) / th;
      e[0] = cosf(0.5f * th); e[1] = kk * phi[0]; e[2] = kk * phi[1]; e[3] = kk * phi[2];
      const float* q = x + a + 3;
      qn[0] = q[0] * e[0] - q[1] * e[1] - q[2] * e[2] - q[3] * e[3];
      qn[1] = q[0] * e[1] + q[1] * e[0] + q[2] * e[3] - q[3] * e[2];
      qn[2] = q[0] * e[2] - q[1] * e[3] + q[2] * e[0] + q[3] * e[1];
      qn[3] = q[0] * e[3] + q[1] * e[2] - q[2] * e[1] + q[3] * e[0];
      quat_normalize(qn, x + a + 3);
    }
  }
  for (int i = lane; i < nv; i += kWarp) x[nq + i] = w.vn[i];
  __syncwarp();
}
