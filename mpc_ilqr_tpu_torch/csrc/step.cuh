// One semi-implicit dynamics step of engine.step, run by a whole block.
//
//   (M + h D + h Jᵀ C J) v' = M v + h (tau + Jᵀ f_el − bias),   q' = integrate(q, v')
//
// Phases (each ends at a __syncthreads() that every thread of the block
// reaches — no barrier sits inside a branch that depends on the thread):
//   FK level by level -> per-dof world axes / anchors -> Jacobian columns
//   -> body angular velocities -> RNEA recursion level by level -> body
//   forces -> M, lhs, bias, tau -> rhs -> Cholesky (right-looking, two
//   barriers per pivot) -> triangular solves in warp 0 -> integration.
// The tree is indexed directly (parent and address arrays), not through the
// one-hot matrices the TPU kernel needed.
#pragma once
#include "step_layout.cuh"

struct Model {
  int B, nq, nv, nu, ncp, nlev, free_qpos, free_dof, free_body;
  const int *parent, *jtype, *qadr, *dadr, *lev_ptr, *lev_body, *act_dof, *cp_body,
      *dof_body, *dof_kind;
  const float *body_pos, *body_quat, *body_ipos, *body_iquat, *body_mass, *body_inertia,
      *jnt_axis, *jnt_pos, *dof_damping, *dof_armature, *anc, *act_gear, *gravity, *cp_pos,
      *cp_radius, *contact;
};

struct Work {
  float *x, *u, *R, *p, *pc, *Rin, *W, *O, *lin, *Jv, *Jw, *G, *omega, *alpha, *acc, *fb,
      *nb, *M, *L, *bias, *tau, *rhs, *y, *vn, *pw, *Jc, *vel, *cd, *fel;
};

__device__ inline Model bind_model(const int* mi, const float* mf) {
  Model m;
  m.B = mi[PI_B]; m.nq = mi[PI_NQ]; m.nv = mi[PI_NV]; m.nu = mi[PI_NU]; m.ncp = mi[PI_NCP];
  m.nlev = mi[PI_NLEV]; m.free_qpos = mi[PI_FREE_QPOS]; m.free_dof = mi[PI_FREE_DOF];
  m.free_body = mi[PI_FREE_BODY];
  m.parent = mi + mi[PI_I_PARENT]; m.jtype = mi + mi[PI_I_JTYPE];
  m.qadr = mi + mi[PI_I_QADR]; m.dadr = mi + mi[PI_I_DADR];
  m.lev_ptr = mi + mi[PI_I_LEV_PTR]; m.lev_body = mi + mi[PI_I_LEV_BODY];
  m.act_dof = mi + mi[PI_I_ACT_DOF]; m.cp_body = mi + mi[PI_I_CP_BODY];
  m.dof_body = mi + mi[PI_I_DOF_BODY]; m.dof_kind = mi + mi[PI_I_DOF_KIND];
  m.body_pos = mf + mi[PI_F_BODY_POS]; m.body_quat = mf + mi[PI_F_BODY_QUAT];
  m.body_ipos = mf + mi[PI_F_BODY_IPOS]; m.body_iquat = mf + mi[PI_F_BODY_IQUAT];
  m.body_mass = mf + mi[PI_F_BODY_MASS]; m.body_inertia = mf + mi[PI_F_BODY_INERTIA];
  m.jnt_axis = mf + mi[PI_F_JNT_AXIS]; m.jnt_pos = mf + mi[PI_F_JNT_POS];
  m.dof_damping = mf + mi[PI_F_DOF_DAMPING]; m.dof_armature = mf + mi[PI_F_DOF_ARMATURE];
  m.anc = mf + mi[PI_F_ANC]; m.act_gear = mf + mi[PI_F_ACT_GEAR];
  m.gravity = mf + mi[PI_F_GRAVITY]; m.cp_pos = mf + mi[PI_F_CP_POS];
  m.cp_radius = mf + mi[PI_F_CP_RADIUS]; m.contact = mf + mi[PI_F_CONTACT];
  return m;
}

// Carves the workspace in the order step_workspace_floats counts it.
__device__ inline Work carve(float* s, const Model& m) {
  const int B = m.B, nv = m.nv, ncp = m.ncp;
  Work w;
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
  w.y = s; s += nv;
  w.vn = s; s += nv;
  w.pw = s; s += 3 * ncp;
  w.Jc = s; s += 3 * ncp * nv;
  w.vel = s; s += 3 * ncp;
  w.cd = s; s += 3 * ncp;
  w.fel = s; s += 3 * ncp;
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

__device__ inline float warp_sum(float s) {
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// Advances w.x (nq + nv floats in shared memory) by one substep of length h
// under the control w.u. Every thread of the block must call it.
__device__ void dyn_step(const Model& m, const Work& w, float h) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int B = m.B, nq = m.nq, nv = m.nv, ncp = m.ncp;
  float* x = w.x;
  const float* v = x + nq;

  // normalize_state: the free base quaternion
  if (tid == 0 && m.free_qpos >= 0) quat_normalize(x + m.free_qpos + 3, x + m.free_qpos + 3);
  __syncthreads();

  // Forward kinematics, one depth level per pass.
  for (int lev = 0; lev < m.nlev; ++lev) {
    for (int k = m.lev_ptr[lev] + tid; k < m.lev_ptr[lev + 1]; k += nt) {
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
      float Rq[9], Ri[9], t[3];
      quat_to_mat(m.body_quat + 4 * b, Rq);
      mat3mul(Rp, Rq, Ri);
      mv3(Rp, m.body_pos + 3 * b, t);
      float pi[3] = {pp[0] + t[0], pp[1] + t[1], pp[2] + t[2]};
      if (jt == JC_HINGE) {
        const float half = 0.5f * x[m.qadr[b]];
        const float s = sinf(half);
        const float* ax = m.jnt_axis + 3 * b;
        const float* jp = m.jnt_pos + 3 * b;
        const float qj[4] = {cosf(half), s * ax[0], s * ax[1], s * ax[2]};
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
    __syncthreads();
  }

  // Per-dof world axes / anchors, body CoMs and inertial frames, contact points.
  for (int i = tid; i < nv; i += nt) {
    const int kind = m.dof_kind[i], b = m.dof_body[i];
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
  }
  for (int b = tid; b < B; b += nt) {
    float t[3], Rq[9];
    mv3(w.R + 9 * b, m.body_ipos + 3 * b, t);
    for (int r = 0; r < 3; ++r) w.pc[3 * b + r] = w.p[3 * b + r] + t[r];
    quat_to_mat(m.body_iquat + 4 * b, Rq);
    mat3mul(w.R + 9 * b, Rq, w.Rin + 9 * b);
  }
  for (int c = tid; c < ncp; c += nt) {
    const int cb = m.cp_body[c];
    float t[3];
    mv3(w.R + 9 * cb, m.cp_pos + 3 * c, t);
    for (int r = 0; r < 3; ++r) w.pw[3 * c + r] = w.p[3 * cb + r] + t[r];
  }
  __syncthreads();

  // Jacobian columns: Jv, Jw, G = Rinᵀ Jw (all (B,3,nv)) and the contact Jc.
  for (int idx = tid; idx < B * nv; idx += nt) {
    const int b = idx / nv, k = idx % nv;
    const float a = m.anc[b * nv + k];
    const float* Wk = w.W + 3 * k;
    float jv[3], jw[3], g[3];
    if (w.lin[k] != 0.f) {
      for (int r = 0; r < 3; ++r) { jv[r] = Wk[r] * a; jw[r] = 0.f; }
    } else {
      float d[3];
      for (int r = 0; r < 3; ++r) d[r] = w.pc[3 * b + r] - w.O[3 * k + r];
      cross3(Wk, d, jv);
      for (int r = 0; r < 3; ++r) { jv[r] *= a; jw[r] = Wk[r] * a; }
    }
    mtv3(w.Rin + 9 * b, jw, g);
    for (int r = 0; r < 3; ++r) {
      w.Jv[(3 * b + r) * nv + k] = jv[r];
      w.Jw[(3 * b + r) * nv + k] = jw[r];
      w.G[(3 * b + r) * nv + k] = g[r];
    }
  }
  for (int idx = tid; idx < ncp * nv; idx += nt) {
    const int c = idx / nv, k = idx % nv;
    const float a = m.anc[m.cp_body[c] * nv + k];
    const float* Wk = w.W + 3 * k;
    float col[3];
    if (w.lin[k] != 0.f) {
      for (int r = 0; r < 3; ++r) col[r] = Wk[r];
    } else {
      float d[3];
      for (int r = 0; r < 3; ++r) d[r] = w.pw[3 * c + r] - w.O[3 * k + r];
      cross3(Wk, d, col);
    }
    for (int r = 0; r < 3; ++r) w.Jc[(3 * c + r) * nv + k] = col[r] * a;
  }
  __syncthreads();

  // Body angular velocities and contact-point velocities.
  for (int idx = tid; idx < 3 * B + 3 * ncp; idx += nt) {
    const float* row = idx < 3 * B ? w.Jw + idx * nv : w.Jc + (idx - 3 * B) * nv;
    float s = 0.f;
    for (int k = 0; k < nv; ++k) s += row[k] * v[k];
    if (idx < 3 * B) w.omega[idx] = s; else w.vel[idx - 3 * B] = s;
  }
  __syncthreads();

  // RNEA outward recursion (velocity-product accelerations at zero v̇).
  for (int lev = 0; lev < m.nlev; ++lev) {
    for (int k = m.lev_ptr[lev] + tid; k < m.lev_ptr[lev + 1]; k += nt) {
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
    __syncthreads();
  }

  // Body forces / torques and the contact damping diagonal + elastic force.
  const float k_c = m.contact[0], d_c = m.contact[1], mu = m.contact[2];
  for (int b = tid; b < B; b += nt) {
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
  for (int c = tid; c < ncp; c += nt) {
    const float depth = m.cp_radius[c] - w.pw[3 * c + 2];
    const float active = depth > 0.f ? 1.f : 0.f;
    const float fn = k_c * depth * active;
    const float vx = w.vel[3 * c], vy = w.vel[3 * c + 1];
    const float eps = 1e-6f / fmaxf(m.contact[3], 1e-3f);
    const float ct = mu * fn / sqrtf(vx * vx + vy * vy + eps);
    const float cn = d_c + h * k_c;
    w.cd[3 * c] = ct * active; w.cd[3 * c + 1] = ct * active; w.cd[3 * c + 2] = cn * active;
    w.fel[3 * c] = 0.f; w.fel[3 * c + 1] = 0.f; w.fel[3 * c + 2] = fn;
  }
  __syncthreads();

  // M, lhs = M + h D + h Jcᵀ C Jc, bias = Jvᵀ f + Jwᵀ n, tau = S gear u + Jcᵀ f_el.
  for (int idx = tid; idx < nv * nv; idx += nt) {
    const int i = idx / nv, j = idx % nv;
    float s = 0.f;
    for (int b = 0; b < B; ++b) {
      const float mb = m.body_mass[b];
      const float* I = m.body_inertia + 3 * b;
      for (int r = 0; r < 3; ++r) {
        const int row = (3 * b + r) * nv;
        s += mb * w.Jv[row + i] * w.Jv[row + j] + w.G[row + i] * I[r] * w.G[row + j];
      }
    }
    if (i == j) s += m.dof_armature[i];
    w.M[idx] = s;
    float cs = 0.f;
    for (int r = 0; r < 3 * ncp; ++r) cs += w.Jc[r * nv + i] * w.cd[r] * w.Jc[r * nv + j];
    w.L[idx] = s + (i == j ? h * m.dof_damping[i] : 0.f) + h * cs;
  }
  for (int i = tid; i < nv; i += nt) {
    float bs = 0.f;
    for (int r = 0; r < 3 * B; ++r) bs += w.Jv[r * nv + i] * w.fb[r] + w.Jw[r * nv + i] * w.nb[r];
    float ts = 0.f;
    for (int a = 0; a < m.nu; ++a)
      if (m.act_dof[a] == i) ts += m.act_gear[a] * w.u[a];
    float tc = 0.f;
    for (int r = 0; r < 3 * ncp; ++r) tc += w.Jc[r * nv + i] * w.fel[r];
    w.bias[i] = bs;
    w.tau[i] = ts + tc;
  }
  __syncthreads();

  for (int i = tid; i < nv; i += nt) {
    float s = 0.f;
    for (int j = 0; j < nv; ++j) s += w.M[i * nv + j] * v[j];
    w.rhs[i] = s + h * (w.tau[i] - w.bias[i]);
  }
  __syncthreads();

  // Cholesky L Lᵀ = lhs in place (lower triangle), right-looking.
  float* L = w.L;
  for (int k = 0; k < nv; ++k) {
    const float d = sqrtf(L[k * nv + k]);  // nobody writes L[k][k] before the barrier
    for (int i = k + 1 + tid; i < nv; i += nt) L[i * nv + k] /= d;
    __syncthreads();
    if (tid == 0) L[k * nv + k] = d;
    const int r = nv - k - 1;
    for (int idx = tid; idx < r * r; idx += nt) {
      const int i = k + 1 + idx / r, j = k + 1 + idx % r;
      if (j <= i) L[i * nv + j] -= L[i * nv + k] * L[j * nv + k];
    }
    __syncthreads();
  }

  // L y = rhs, Lᵀ v' = y: warp 0, one row at a time, lanes split the dot.
  if (tid < 32) {
    const int lane = tid;
    for (int i = 0; i < nv; ++i) {
      float s = 0.f;
      for (int j = lane; j < i; j += 32) s += L[i * nv + j] * w.y[j];
      s = warp_sum(s);
      if (lane == 0) w.y[i] = (w.rhs[i] - s) / L[i * nv + i];
      __syncwarp();
    }
    for (int i = nv - 1; i >= 0; --i) {
      float s = 0.f;
      for (int j = i + 1 + lane; j < nv; j += 32) s += L[j * nv + i] * w.vn[j];
      s = warp_sum(s);
      if (lane == 0) w.vn[i] = (w.y[i] - s) / L[i * nv + i];
      __syncwarp();
    }
  }
  __syncthreads();

  // Semi-implicit integration with the new velocity.
  for (int b = tid; b < B; b += nt) {
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
  for (int i = tid; i < nv; i += nt) x[nq + i] = w.vn[i];
  __syncthreads();
}
