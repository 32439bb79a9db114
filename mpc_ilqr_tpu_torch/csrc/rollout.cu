// Rollout kernels for Hopper (sm_90a): the serial dynamics chains of the
// iLQR solver, one thread block per chain, the model and the state in
// shared memory, a loop over t inside the block.
//
//   rollout_open      replaces the TPU kernel rollout_pallas
//                     (mpc_ilqr_tpu/ops/rollout_kernel.py:61, body
//                     ops/quat_step.py:229 step_mosaic): x_{t+1} = f(x_t, u_t).
//   rollout_feedback  replaces linesearch_rollout_pallas (:108) and
//                     linesearch_rollout_pallas_batched (:208, body
//                     ops/quat_step_batch.py:281): one block per alpha,
//                     u_t = ū_t + α k_t + K_t (x_t − x̄_t), x_{t+1} = f(x_t, u_t).
//                     The batched TPU kernel exists because TPU grid steps run
//                     in series; blocks here run side by side, so both
//                     contracts share this kernel and its alpha-major output.
//
// Bound on this card (H1: nx=51, nu=19, nv=25, 20 bodies, 8 contact points,
// N=25; counts from chip_smoke.py's chain_flops and byte tally). Bytes: the
// feedback chain reads K (N·nu·nx floats = 97 KB) plus x̄, ū, k and the
// packed model once and writes A·(N+1)·nx + A·N·nu floats: 0.12 MB at
// A=1, 0.035 µs at 3.35 TB/s. Operations, counting only structurally
// non-zero work (a body's Jacobian has columns at its ancestor dofs alone;
// M and the lhs are symmetric): about 46 kflop per step with all 8 contact
// points down (M's triangle 16k, Jacobian columns, velocities and bias 8k,
// contacts 7k, Cholesky and solves 6.5k), 1.2 MFLOP per 25-step chain,
// 0.017 µs at 67 TFLOP/s fp32. Both bounds are far below what a 25-step
// chain of dependent steps takes: each step is about 70 block barriers
// (tree levels, two per Cholesky pivot) plus 50 dependent triangular-solve
// rows, so the chain is bound by latency — barrier and shared-memory round
// trips — not by bytes or operations. The design answers that by keeping
// every operand of the chain in shared memory for its whole length (one
// launch, no device memory traffic inside the loop), by spreading each
// phase over the block's threads, by one block per alpha so the alphas of a
// line search run in parallel instead of in series, and by solving the
// triangular systems in one warp with shuffles instead of block barriers.
#include <cuda_runtime.h>

#include "step.cuh"

namespace {

constexpr int kThreads = 256;

__device__ void load_model(const float* __restrict__ fbuf, const int* __restrict__ ibuf,
                           int n_float, int n_int, int* mi, float* mf) {
  for (int i = threadIdx.x; i < n_int; i += blockDim.x) mi[i] = ibuf[i];
  for (int i = threadIdx.x; i < n_float; i += blockDim.x) mf[i] = fbuf[i];
  __syncthreads();
}

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
  const int nx = m.nq + m.nv;

  for (int i = threadIdx.x; i < nx; i += blockDim.x) {
    w.x[i] = x0[i];
    xs[i] = x0[i];
  }
  for (int t = 0; t < N; ++t) {
    for (int i = threadIdx.x; i < m.nu; i += blockDim.x) w.u[i] = us[t * m.nu + i];
    __syncthreads();
    for (int s = 0; s < n_sub; ++s) dyn_step(m, w, h);
    for (int i = threadIdx.x; i < nx; i += blockDim.x) xs[(t + 1) * nx + i] = w.x[i];
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
  const int nx = m.nq + m.nv, nu = m.nu;
  const long long a = blockIdx.x;
  const float alpha = alphas[a];
  float* xs_a = xs + a * (N + 1) * nx;
  float* us_a = us + a * N * nu;

  for (int i = threadIdx.x; i < nx; i += blockDim.x) {
    w.x[i] = x0[i];
    xs_a[i] = x0[i];
  }
  __syncthreads();
  for (int t = 0; t < N; ++t) {
    for (int r = threadIdx.x; r < nu; r += blockDim.x) {
      const float* Kr = K + ((long long)t * nu + r) * nx;
      const float* xb = xbar + (long long)t * nx;
      float s = 0.f;
      for (int j = 0; j < nx; ++j) s += Kr[j] * (w.x[j] - xb[j]);
      const float u = ubar[t * nu + r] + alpha * kff[t * nu + r] + s;
      w.u[r] = u;
      us_a[t * nu + r] = u;
    }
    __syncthreads();
    for (int s = 0; s < n_sub; ++s) dyn_step(m, w, h);
    for (int i = threadIdx.x; i < nx; i += blockDim.x) xs_a[(t + 1) * nx + i] = w.x[i];
  }
}

size_t smem_bytes(int n_float, int n_int, int B, int nq, int nv, int nu, int ncp) {
  return sizeof(float) * (size_t)(n_int + n_float + step_workspace_floats(B, nq, nv, nu, ncp));
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

long long mpc_smem_bytes(int n_float, int n_int, int B, int nq, int nv, int nu, int ncp) {
  return (long long)smem_bytes(n_float, n_int, B, nq, nv, nu, ncp);
}

// Open-loop chain: xs (N+1, nx) from x0 (nx,) and us (N, nu).
int mpc_rollout_open(const float* fbuf, const int* ibuf, int n_float, int n_int, int B, int nq,
                     int nv, int nu, int ncp, const float* x0, const float* us, float* xs, int N,
                     int n_sub, float h, void* stream) {
  const size_t bytes = smem_bytes(n_float, n_int, B, nq, nv, nu, ncp);
  int rc = prepare(rollout_open, bytes);
  if (rc) return rc;
  rollout_open<<<1, kThreads, bytes, (cudaStream_t)stream>>>(fbuf, ibuf, n_float, n_int, x0, us,
                                                             xs, N, n_sub, h);
  return (int)cudaGetLastError();
}

// Closed-loop chains, one block per alpha: xs (A, N+1, nx), us (A, N, nu)
// from x0 (nx,), xbar (N+1, nx), ubar (N, nu), K (N, nu, nx), kff (N, nu).
int mpc_rollout_feedback(const float* fbuf, const int* ibuf, int n_float, int n_int, int B,
                         int nq, int nv, int nu, int ncp, const float* x0, const float* xbar,
                         const float* ubar, const float* K, const float* kff,
                         const float* alphas, int A, float* xs, float* us, int N, int n_sub,
                         float h, void* stream) {
  const size_t bytes = smem_bytes(n_float, n_int, B, nq, nv, nu, ncp);
  int rc = prepare(rollout_feedback, bytes);
  if (rc) return rc;
  rollout_feedback<<<A, kThreads, bytes, (cudaStream_t)stream>>>(
      fbuf, ibuf, n_float, n_int, x0, xbar, ubar, K, kff, alphas, xs, us, N, n_sub, h);
  return (int)cudaGetLastError();
}

}  // extern "C"
