// The Riccati backward pass for Hopper (sm_90a): the whole recursion
// t = N-1 .. 0 in one launch, one thread block, the value function (Vx, Vxx)
// in shared memory for the whole pass.
//
//   riccati_backward  replaces the TPU kernel backward_pass_pallas
//                     (mpc_ilqr_tpu/ops/riccati.py:143; body _riccati_kernel
//                     :94, _chol_masked :43, _solve_chol :67).
//
// At each t it forms Qx = lx + AᵀVx, Qu = lu + BᵀVx, Qxx = lxx + AᵀVxxA,
// Qxu = AᵀVxxB and Quu = luu + BᵀVxxB + λI; factors Quu by Cholesky, and
// when that factor has a non-finite entry adds pd_bump·I and factors again;
// solves Quu [K | k] = −[Qxuᵀ | Qu]; writes K_t, k_t; and updates
// Vx = Qx + Kᵀ(Quu k + Qu) + Qxu k, Vxx = Qxx + KᵀQuuK + KᵀQxuᵀ + QxuK,
// symmetrized. The TPU kernel's padding to multiples of 8 and its
// masked-matvec pivot access were Mosaic constraints (no dynamic value
// indexing); here the sizes are runtime ints and the pivots are indexed.
// Limits: nx ≤ kMaxNx, nu ≤ kMaxNu (the Cholesky runs in one warp, a lane
// per row); mpc_riccati_backward refuses larger sizes.
//
// Non-finite behaviour is the reference's: a non-positive pivot gives
// rsqrtf's NaN or inf, which propagates into K, k and the value function,
// as rsqrt does on the TPU. Nothing is clamped or skipped.
//
// Bound on this card (H1: nx=51, nu=19; counts from chip_smoke.py's
// riccati_flops, one triangle of each symmetric result). Operations: about
// 0.81 Mflop per t — AᵀVxx 265k, one triangle of Qxx = lxx + AᵀVxx·A 135k,
// BᵀVxx and Qxu 99k each, one triangle of the Vxx update 101k, the rest
// about 0.11M, and 2.5k more where the PD bump fires — so 80.7 Mflop at
// N=100, 1.20 µs at 67 TFLOP/s fp32 (this kernel computes the full squares,
// about 1.11 Mflop per t). Bytes: A, B, lx, lu, lxx, luu read once and K, k written
// once, 3.05 MB at N=100, 0.91 µs at 3.35 TB/s. The recursion is serial in
// t, and each t is seven dependent block-wide phases (one barrier each)
// plus 2·nu warp barriers per Cholesky and the nu-row substitutions, so the
// pass is bound by latency — barriers and shared-memory round trips — not
// by bytes or operations. The design keeps every operand of a step in
// shared memory (A_t and B_t staged with coalesced loads, the carry never
// leaves the block), spreads each product over the block with one thread
// per output entry, runs the Cholesky in one warp so its pivots need warp
// barriers only, and solves the nx+1 right-hand-side columns in parallel,
// one thread each. Tensor cores (wgmma), TMA staging and several blocks are
// left for later.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNx = 64;
constexpr int kMaxNu = 32;

struct Buffers {
  float *Vxx, *A, *AtV, *Qxx, *T;  // nx·nx
  float *B, *BtV, *Qxu;            // nx·nu
  float *Quu, *S, *L;              // nu·nu
  float *X, *QX;                   // nu·(nx+1): [K | k] and Quu·[K | k] + [0 | Qu]
  float *Vx, *Qx, *Qu;
};

__host__ __device__ inline size_t smem_floats(int nx, int nu) {
  return 5 * (size_t)nx * nx + 3 * (size_t)nx * nu + 3 * (size_t)nu * nu +
         2 * (size_t)nu * (nx + 1) + 2 * (size_t)nx + nu;
}

__device__ inline Buffers carve(float* s, int nx, int nu) {
  Buffers b;
  b.Vxx = s; s += nx * nx;
  b.A = s; s += nx * nx;
  b.AtV = s; s += nx * nx;
  b.Qxx = s; s += nx * nx;
  b.T = s; s += nx * nx;
  b.B = s; s += nx * nu;
  b.BtV = s; s += nx * nu;
  b.Qxu = s; s += nx * nu;
  b.Quu = s; s += nu * nu;
  b.S = s; s += nu * nu;
  b.L = s; s += nu * nu;
  b.X = s; s += nu * (nx + 1);
  b.QX = s; s += nu * (nx + 1);
  b.Vx = s; s += nx;
  b.Qx = s; s += nx;
  b.Qu = s;
  return b;
}

// Cholesky of S (nu×nu, row-major; its lower triangle is overwritten) into
// the lower triangle of L, by warp 0 with lane i on row i: right-looking,
// one pivot at a time, as _chol_masked. Returns to every lane whether any
// entry of the factor is not finite — the reference's test, one value for
// the whole warp.
__device__ bool chol_warp(float* S, float* L, int nu) {
  const int i = threadIdx.x;
  for (int k = 0; k < nu; ++k) {
    const float inv = rsqrtf(S[k * nu + k]);  // S[k][k] was last written before the previous __syncwarp
    if (i >= k && i < nu) L[i * nu + k] = S[i * nu + k] * inv;
    __syncwarp();
    if (i > k && i < nu) {
      const float lik = L[i * nu + k];
      for (int j = k + 1; j <= i; ++j) S[i * nu + j] -= lik * L[j * nu + k];
    }
    __syncwarp();
  }
  bool bad = false;
  if (i < nu)
    for (int k = 0; k <= i; ++k) bad |= !isfinite(L[i * nu + k]);
  return __any_sync(0xffffffffu, bad);
}

__global__ void __launch_bounds__(kThreads)
riccati_backward(const float* __restrict__ A, const float* __restrict__ B,
                 const float* __restrict__ lx, const float* __restrict__ lu,
                 const float* __restrict__ lxx, const float* __restrict__ luu,
                 const float* __restrict__ reg_ptr, float pd_bump, float* __restrict__ K,
                 float* __restrict__ kff, int N, int nx, int nu) {
  extern __shared__ float smem[];
  const Buffers b = carve(smem, nx, nu);
  const int tid = threadIdx.x, nt = blockDim.x, ld = nx + 1;
  const int nxx = nx * nx, nxu = nx * nu, nuu = nu * nu;
  const float reg = *reg_ptr;

  auto stage = [&](int t) {  // A_t, B_t into shared memory, coalesced
    const float* At = A + (size_t)t * nxx;
    const float* Bt = B + (size_t)t * nxu;
    for (int e = tid; e < nxx; e += nt) b.A[e] = At[e];
    for (int e = tid; e < nxu; e += nt) b.B[e] = Bt[e];
  };

  for (int e = tid; e < nxx; e += nt) b.Vxx[e] = lxx[(size_t)N * nxx + e];
  for (int e = tid; e < nx; e += nt) b.Vx[e] = lx[(size_t)N * nx + e];
  stage(N - 1);
  __syncthreads();

  for (int t = N - 1; t >= 0; --t) {
    // 1. AtV = AᵀVxx, BtV = BᵀVxx, Qx = lx + AᵀVx, Qu = lu + BᵀVx
    for (int e = tid; e < nxx + nxu + nx + nu; e += nt) {
      float s = 0.f;
      if (e < nxx) {
        const int i = e / nx, j = e % nx;
        for (int k = 0; k < nx; ++k) s += b.A[k * nx + i] * b.Vxx[k * nx + j];
        b.AtV[e] = s;
      } else if (e < nxx + nxu) {
        const int f = e - nxx, r = f / nx, j = f % nx;
        for (int k = 0; k < nx; ++k) s += b.B[k * nu + r] * b.Vxx[k * nx + j];
        b.BtV[f] = s;
      } else if (e < nxx + nxu + nx) {
        const int i = e - nxx - nxu;
        for (int k = 0; k < nx; ++k) s += b.A[k * nx + i] * b.Vx[k];
        b.Qx[i] = lx[(size_t)t * nx + i] + s;
      } else {
        const int r = e - nxx - nxu - nx;
        for (int k = 0; k < nx; ++k) s += b.B[k * nu + r] * b.Vx[k];
        b.Qu[r] = lu[(size_t)t * nu + r] + s;
      }
    }
    __syncthreads();

    // 2. Qxx = lxx + AtV·A, Qxu = AtV·B, Quu = luu + BtV·B + λI
    for (int e = tid; e < nxx + nxu + nuu; e += nt) {
      float s = 0.f;
      if (e < nxx) {
        const int i = e / nx, j = e % nx;
        for (int k = 0; k < nx; ++k) s += b.AtV[i * nx + k] * b.A[k * nx + j];
        b.Qxx[e] = lxx[(size_t)t * nxx + e] + s;
      } else if (e < nxx + nxu) {
        const int f = e - nxx, i = f / nu, r = f % nu;
        for (int k = 0; k < nx; ++k) s += b.AtV[i * nx + k] * b.B[k * nu + r];
        b.Qxu[f] = s;
      } else {
        const int f = e - nxx - nxu, r = f / nu, c = f % nu;
        for (int k = 0; k < nx; ++k) s += b.BtV[r * nx + k] * b.B[k * nu + c];
        float q = luu[(size_t)t * nuu + f] + s;
        if (r == c) q += reg;
        b.Quu[f] = q;
      }
    }
    __syncthreads();

    // 3. Factor Quu in warp 0; on a non-finite factor bump and factor again.
    if (tid < 32) {
      for (int e = tid; e < nuu; e += 32) b.S[e] = b.Quu[e];
      __syncwarp();
      if (chol_warp(b.S, b.L, nu)) {  // warp-uniform
        if (tid < nu) b.Quu[tid * nu + tid] += pd_bump;
        __syncwarp();
        for (int e = tid; e < nuu; e += 32) b.S[e] = b.Quu[e];
        __syncwarp();
        chol_warp(b.S, b.L, nu);
      }
    }
    __syncthreads();

    // 4. Solve L Lᵀ X = −[Qxuᵀ | Qu], one thread per column; write K_t, k_t.
    if (tid < ld) {
      const int c = tid;
      float* col = b.X + c;
      for (int k = 0; k < nu; ++k) {
        float s = c < nx ? b.Qxu[c * nu + k] : b.Qu[k];
        for (int j = 0; j < k; ++j) s -= b.L[k * nu + j] * col[j * ld];
        col[k * ld] = s / b.L[k * nu + k];
      }
      for (int k = nu - 1; k >= 0; --k) {
        float s = col[k * ld];
        for (int j = k + 1; j < nu; ++j) s -= b.L[j * nu + k] * col[j * ld];
        col[k * ld] = s / b.L[k * nu + k];
      }
      for (int r = 0; r < nu; ++r) {
        const float v = -col[r * ld];
        col[r * ld] = v;
        if (c < nx) K[((size_t)t * nu + r) * nx + c] = v;
        else kff[(size_t)t * nu + r] = v;
      }
    }
    __syncthreads();

    // 5. QX = Quu·[K | k] + [0 | Qu]
    for (int e = tid; e < nu * ld; e += nt) {
      const int r = e / ld, j = e % ld;
      float s = j == nx ? b.Qu[r] : 0.f;
      for (int k = 0; k < nu; ++k) s += b.Quu[r * nu + k] * b.X[k * ld + j];
      b.QX[e] = s;
    }
    __syncthreads();

    // 6. Vx = Qx + Kᵀ(Quu k + Qu) + Qxu k; T = Qxx + KᵀQuuK + KᵀQxuᵀ + QxuK
    for (int e = tid; e < nxx + nx; e += nt) {
      if (e < nxx) {
        const int i = e / nx, j = e % nx;
        float s = b.Qxx[e];
        for (int r = 0; r < nu; ++r)
          s += b.X[r * ld + i] * (b.QX[r * ld + j] + b.Qxu[j * nu + r]) +
               b.Qxu[i * nu + r] * b.X[r * ld + j];
        b.T[e] = s;
      } else {
        const int i = e - nxx;
        float s = b.Qx[i];
        for (int r = 0; r < nu; ++r)
          s += b.X[r * ld + i] * b.QX[r * ld + nx] + b.Qxu[i * nu + r] * b.X[r * ld + nx];
        b.Vx[i] = s;
      }
    }
    __syncthreads();

    // 7. Vxx = (T + Tᵀ)/2, and stage the next step's A, B.
    for (int e = tid; e < nxx; e += nt) {
      const int i = e / nx, j = e % nx;
      b.Vxx[e] = 0.5f * (b.T[e] + b.T[j * nx + i]);
    }
    if (t > 0) stage(t - 1);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

long long mpc_riccati_smem_bytes(int nx, int nu) {
  return (long long)(sizeof(float) * smem_floats(nx, nu));
}

// K (N, nu, nx), kff (N, nu) from A (N, nx, nx), B (N, nx, nu), lx (N+1, nx),
// lu (N, nu), lxx (N+1, nx, nx), luu (N, nu, nu), all row-major float32 on
// the device, and λ as one float on the device (no host read of it).
int mpc_riccati_backward(const float* A, const float* B, const float* lx, const float* lu,
                         const float* lxx, const float* luu, const float* reg, float pd_bump,
                         float* K, float* kff, int N, int nx, int nu, void* stream) {
  if (N < 1 || nx < 1 || nu < 1 || nx > kMaxNx || nu > kMaxNu) return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * smem_floats(nx, nu);
  // Above 48 KB a block's shared memory must be opted into (227 KB max).
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(riccati_backward,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  riccati_backward<<<1, kThreads, bytes, (cudaStream_t)stream>>>(A, B, lx, lu, lxx, luu, reg,
                                                                 pd_bump, K, kff, N, nx, nu);
  return (int)cudaGetLastError();
}

}  // extern "C"
