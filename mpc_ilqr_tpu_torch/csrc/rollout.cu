// Rollout kernels for Hopper (sm_90a): the serial dynamics chains of the
// iLQR solver, one block of four warps per chain, the model and the state in
// shared memory, a loop over t inside the block.
//
//   rollout_open      replaces the TPU kernel rollout_pallas
//                     (mpc_ilqr_tpu/ops/rollout_kernel.py:61, body
//                     ops/quat_step.py:229 step_mosaic): x_{t+1} = f(x_t, u_t).
//   rollout_feedback  replaces linesearch_rollout_pallas (:108) and
//                     linesearch_rollout_pallas_batched (:208, body
//                     ops/quat_step_batch.py:281): one block per alpha,
//                     u_t = ū_t + α k_t + K_t (x_t − x̄_t), x_{t+1} = f(x_t, u_t).
//                     The batched TPU kernel exists because TPU grid steps
//                     run in series; blocks here run side by side, so both
//                     contracts share this kernel and its alpha-major output.
//
// Bound on this card (H1: nx=51, nu=19, nv=25, 20 bodies, 8 contact points,
// N=25; counts from chip_smoke.py's chain_flops and byte tally). Bytes: the
// feedback chain reads K (N·nu·nx floats = 97 KB) plus x̄, ū, k and the
// model once (its arrays and tree, 2.8 KB: step_plan.model_bytes, not the
// plan's schedule lists) and writes A·(N+1)·nx + A·N·nu floats: 0.116 MB
// at A=1, 0.035 µs at 3.35 TB/s. Operations, counting only structurally
// non-zero work: about 46 kflop per step with all 8 contact points down,
// 1.2 MFLOP per 25-step chain, 0.017 µs at 67 TFLOP/s fp32. Both bounds are
// far below what a 25-step chain of dependent steps takes, so the chain is
// bound by latency: the dependent phases of a step, their synchronisation
// and their shared-memory round trips. The design answers that by
//   - four warps per chain (step.cuh): the serial phases in warp 0 between
//     __syncwarp()s, the bulky ones on all four warps between six named
//     block barriers per step, the triangular substitutions on warp 1 a
//     column behind warp 0's factor: no block barrier inside the factor or
//     the substitutions;
//   - work only where the model has it: Jacobian columns, velocities, M,
//     the lhs and the bias over the plan's ancestor lists, contact rows only
//     of points on the ground, the assembly dealt evenly to the threads by
//     the plan, constant rotations computed once per launch;
//   - every operand of the chain in shared memory for its whole length, and
//     the next step's inputs (K_{t+1}, x̄_{t+1}, ū_{t+1}, k_{t+1}, or u_{t+1})
//     staged by cp.async into a second buffer while step t runs, so the
//     feedback law reads shared memory only; the law and the staging run on
//     warp 1 while warp 0 runs the step's forward kinematics, off the
//     chain's critical path;
//   - one block per alpha, so the alphas of a line search run side by side.
// Each sum keeps the dense formulation's order (step.cuh), so the kernels'
// results do not depend on this schedule.
#include <cuda_runtime.h>

#include "step.cuh"

namespace {

__device__ inline void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Waits for this lane's copies; a __syncwarp() after it publishes all lanes'.
__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// One warp's lanes copy n floats global -> shared asynchronously.
__device__ inline void stage(float* dst, const float* src, int n) {
  for (int i = threadIdx.x & (kWarp - 1); i < n; i += kWarp) cp_async4(dst + i, src + i);
}

// The packed model into shared memory (every thread of the block).
__device__ void load_model(const float* __restrict__ fbuf, const int* __restrict__ ibuf,
                           int n_float, int n_int, int* mi, float* mf) {
  for (int i = threadIdx.x; i < n_int; i += kThreads) mi[i] = ibuf[i];
  for (int i = threadIdx.x; i < n_float; i += kThreads) mf[i] = fbuf[i];
  __syncthreads();
}

// Named barrier 2 between warp 0 (arrives) and warp 1 (waits): the feedback
// law's x − x̄ is ready.
__device__ inline void dx_ready_arrive() {
  asm volatile("bar.arrive 2, %0;\n" ::"r"(2 * kWarp) : "memory");
}
__device__ inline void dx_ready_wait() {
  asm volatile("bar.sync 2, %0;\n" ::"r"(2 * kWarp) : "memory");
}

// Warp 1, while warp 0 runs the step's forward kinematics (the control is
// first read by the assembly): u = ū + α k + K (x − x̄) from the staged step
// inputs st = [K | x̄ | ū | k] and w.dx = x − x̄, lane r on row r, each row's
// products summed in ascending column order (off the critical path, the
// order matters more than the latency).
__device__ void feedback_law(const Model& m, const Work& w, const float* st, float alpha,
                             float* __restrict__ u_out) {
  const int nx = m.nq + m.nv, nu = m.nu;
  const float *Kt = st, *ub = st + nu * nx + nx, *kf = ub + nu;
  for (int r = threadIdx.x - kWarp; r < nu; r += kWarp) {
    float s = 0.f;
    for (int j = 0; j < nx; ++j) s += Kt[r * nx + j] * w.dx[j];
    const float u = ub[r] + alpha * kf[r] + s;
    w.u[r] = u;
    u_out[r] = u;
  }
}

// Both kernels: every thread steps (dyn_step's block phases need the whole
// block); warp 0 writes the outputs; in rollout_feedback warp 1 applies the
// feedback law and stages the next step's inputs.
__global__ void __launch_bounds__(kThreads)
rollout_open(const float* __restrict__ fbuf, const int* __restrict__ ibuf, int n_float, int n_int,
             const float* __restrict__ x0, const float* __restrict__ us,
             float* __restrict__ xs, int N, int n_sub, float h) {
  extern __shared__ float smem[];
  int* mi = reinterpret_cast<int*>(smem);
  float* mf = smem + n_int;
  load_model(fbuf, ibuf, n_float, n_int, mi, mf);
  const Model m = bind_model(mi, mf);
  const Work w = carve(mf + n_float, m);
  const int nx = m.nq + m.nv, nu = m.nu;
  const bool warp0 = threadIdx.x < kWarp;
  float* ubuf = mf + n_float + step_workspace_floats(m.B, m.nq, m.nv, nu, m.ncp);  // 2 x nu
  if (warp0 && N > 0) {
    stage(ubuf, us, nu);
    cp_async_commit();
  }
  init_work(m, w);
  if (warp0) {
    for (int i = threadIdx.x; i < nx; i += kWarp) {
      w.x[i] = x0[i];
      xs[i] = x0[i];
    }
  }
  for (int t = 0; t < N; ++t) {
    if (warp0) {
      cp_async_wait_all();
      __syncwarp();  // u_t (and x at t = 0) visible to the warp
      if (t + 1 < N) {
        stage(ubuf + ((t + 1) & 1) * nu, us + (long long)(t + 1) * nu, nu);
        cp_async_commit();
      }
    }
    for (int s = 0; s < n_sub; ++s) dyn_step(m, w, ubuf + (t & 1) * nu, h, 1 + t * n_sub + s);
    if (warp0)
      for (int i = threadIdx.x; i < nx; i += kWarp) xs[(long long)(t + 1) * nx + i] = w.x[i];
  }
}

__global__ void __launch_bounds__(kThreads)
rollout_feedback(const float* __restrict__ fbuf, const int* __restrict__ ibuf, int n_float,
                 int n_int, const float* __restrict__ x0, const float* __restrict__ xbar,
                 const float* __restrict__ ubar, const float* __restrict__ K,
                 const float* __restrict__ kff, const float* __restrict__ alphas,
                 float* __restrict__ xs, float* __restrict__ us, int N, int n_sub, float h) {
  extern __shared__ float smem[];
  int* mi = reinterpret_cast<int*>(smem);
  float* mf = smem + n_int;
  load_model(fbuf, ibuf, n_float, n_int, mi, mf);
  const Model m = bind_model(mi, mf);
  const Work w = carve(mf + n_float, m);
  const int nx = m.nq + m.nv, nu = m.nu, per = nu * nx + nx + 2 * nu;
  const bool warp0 = threadIdx.x < kWarp;
  float* buf = mf + n_float + step_workspace_floats(m.B, m.nq, m.nv, nu, m.ncp);  // 2 x per
  auto issue = [&](int t, float* dst) {  // [K_t | x̄_t | ū_t | k_t]
    stage(dst, K + (long long)t * nu * nx, nu * nx);
    stage(dst + nu * nx, xbar + (long long)t * nx, nx);
    stage(dst + nu * nx + nx, ubar + (long long)t * nu, nu);
    stage(dst + nu * nx + nx + nu, kff + (long long)t * nu, nu);
    cp_async_commit();
  };
  // Warp 1 stages step t + 1's inputs after step t's feedback law and waits
  // for them before the step's first block barrier, which publishes them.
  const bool warp1 = threadIdx.x >= kWarp && threadIdx.x < 2 * kWarp;
  if (warp1 && N > 0) {
    issue(0, buf);
    cp_async_wait_all();
  }
  init_work(m, w);
  const long long a = blockIdx.x;
  const float alpha = alphas[a];
  float* xs_a = xs + a * (N + 1) * nx;
  float* us_a = us + a * N * nu;
  if (warp0) {
    for (int i = threadIdx.x; i < nx; i += kWarp) {
      w.x[i] = x0[i];
      xs_a[i] = x0[i];
    }
  }
  for (int t = 0; t < N; ++t) {
    const float* st = buf + (t & 1) * per;
    if (warp0) {
      __syncwarp();  // x at t = 0
      for (int j = threadIdx.x; j < nx; j += kWarp) w.dx[j] = w.x[j] - st[nu * nx + j];
      dx_ready_arrive();
    } else if (warp1) {
      dx_ready_wait();
      feedback_law(m, w, st, alpha, us_a + (long long)t * nu);
      if (t + 1 < N) {
        issue(t + 1, buf + ((t + 1) & 1) * per);
        cp_async_wait_all();
      }
    }
    for (int s = 0; s < n_sub; ++s) dyn_step(m, w, w.u, h, 1 + t * n_sub + s);
    if (warp0)
      for (int i = threadIdx.x; i < nx; i += kWarp) xs_a[(long long)(t + 1) * nx + i] = w.x[i];
  }
}

size_t smem_bytes(int n_float, int n_int, int B, int nq, int nv, int nu, int ncp, bool feedback) {
  const int nx = nq + nv;
  const int staged = feedback ? 2 * (nu * nx + nx + 2 * nu) : 2 * nu;
  return sizeof(float) * (size_t)(n_int + n_float + step_workspace_floats(B, nq, nv, nu, ncp) +
                                  staged);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t bytes) {
  // Above 48 KB a block's shared memory must be opted into (227 KB max).
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

extern "C" {

const char* mpc_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Shared memory per block of rollout_feedback (the larger of the two).
long long mpc_smem_bytes(int n_float, int n_int, int B, int nq, int nv, int nu, int ncp) {
  return (long long)smem_bytes(n_float, n_int, B, nq, nv, nu, ncp, true);
}

// Open-loop chain: xs (N+1, nx) from x0 (nx,) and us (N, nu).
int mpc_rollout_open(const float* fbuf, const int* ibuf, int n_float, int n_int, int B, int nq,
                     int nv, int nu, int ncp, const float* x0, const float* us, float* xs, int N,
                     int n_sub, float h, void* stream) {
  const size_t bytes = smem_bytes(n_float, n_int, B, nq, nv, nu, ncp, false);
  int rc = prepare(rollout_open, bytes);
  if (rc) return rc;
  rollout_open<<<1, kThreads, bytes, (cudaStream_t)stream>>>(fbuf, ibuf, n_float, n_int, x0, us, xs,
                                                          N, n_sub, h);
  return (int)cudaGetLastError();
}

// Closed-loop chains, one block per alpha: xs (A, N+1, nx), us (A, N, nu)
// from x0 (nx,), xbar (N+1, nx), ubar (N, nu), K (N, nu, nx), kff (N, nu).
int mpc_rollout_feedback(const float* fbuf, const int* ibuf, int n_float, int n_int, int B,
                         int nq, int nv, int nu, int ncp, const float* x0, const float* xbar,
                         const float* ubar, const float* K, const float* kff,
                         const float* alphas, int A, float* xs, float* us, int N, int n_sub,
                         float h, void* stream) {
  const size_t bytes = smem_bytes(n_float, n_int, B, nq, nv, nu, ncp, true);
  int rc = prepare(rollout_feedback, bytes);
  if (rc) return rc;
  rollout_feedback<<<A, kThreads, bytes, (cudaStream_t)stream>>>(
      fbuf, ibuf, n_float, n_int, x0, xbar, ubar, K, kff, alphas, xs, us, N, n_sub, h);
  return (int)cudaGetLastError();
}

}  // extern "C"
