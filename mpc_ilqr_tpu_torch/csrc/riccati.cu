// The Riccati backward pass for Hopper (sm_90a): the whole recursion
// t = N-1 .. 0 in one launch, one thread block per instance, the value
// function (Vx, Vxx) in shared memory for the whole pass.
//
//   riccati_backward       replaces the TPU kernel backward_pass_pallas
//                          (mpc_ilqr_tpu/ops/riccati.py:143; body
//                          _riccati_kernel :94, _chol_masked :43,
//                          _solve_chol :67) for nx <= 64, nu <= 32
//   riccati_backward_wide  the same for every larger size up to
//                          nx <= kMaxNxW = 128, nu <= kMaxNuW = 64
//
// A launch covers a batch of instances, one block each (gridDim.x = batch):
// block b reads its instance's inputs at stride, its λ from reg[b], and
// takes its own bump decision, as vmap gives the Pallas kernel one grid step
// per instance. The single-instance call is a batch of one.
//
// At each t it forms Qx = lx + AᵀVx, Qu = lu + BᵀVx, Qxx = lxx + AᵀVxxA,
// Qxu = AᵀVxxB and Quu = luu + BᵀVxxB + λI; factors Quu by Cholesky, and
// when that factor has a non-finite entry adds pd_bump·I and factors again;
// solves Quu [K | k] = −[Qxuᵀ | Qu]; writes K_t, k_t; and updates
// Vx = Qx + Kᵀ(Quu k + Qu) + Qxu k, Vxx = ½(T + Tᵀ) with
// T = Qxx + KᵀQuuK + KᵀQxuᵀ + QxuK. The TPU kernel's padding to multiples
// of 8 and its masked-matvec pivot access were Mosaic constraints (no
// dynamic value indexing); here the sizes are runtime ints and the pivots
// are indexed. mpc_riccati_backward_batched refuses sizes above the wide
// design's limits.
//
// Non-finite behaviour is the reference's: a non-positive pivot gives
// rsqrtf's NaN or inf, which propagates into K, k and the value function,
// as rsqrt does on the TPU; the bump is one warp-wide decision over the
// whole factor. Nothing is clamped or skipped. Full fp32 throughout.
//
// Bound on this card (H1: nx=51, nu=19; counts from chip_smoke.py's
// riccati_flops, one triangle of each symmetric result): about 0.81 Mflop
// per t, 80.7 Mflop at N=100, 1.20 µs at 67 TFLOP/s fp32; 3.05 MB of inputs
// and outputs at N=100, 0.91 µs at 3.35 TB/s. The recursion is serial in t,
// so the pass is bound by latency: each t is a chain of dependent products
// (about 0.5 M padded FMA on one SM) around a serial factor and solve. Per t,
// four phases, one block barrier each:
//   1. all warps: BᵀVV and AᵀVV, VV = [Vxx | Vx], so Qx and Qu come out of
//      the same tiles as AᵀVxx and BᵀVxx (stored transposed);
//   2. warps 0-3 form Quu (named barrier 2), then warp 0 factors it; beside
//      them warps 4-7, and warps 1-3 once Quu is done, form Qxu (into
//      R = [Qxuᵀ | Qu]) and Qxx;
//   3. one thread per right-hand-side column solves it and forms its column
//      of P = Quu·[K | k] + R, while the other warps stage the next knot's
//      inputs (and, for nx > 60, form the Qxx tiles phase 2 left);
//   4. all warps write K_t and k_t, and form T = Qxx + [K | k]ᵀP + Rᵀ[K | k],
//      writing Vxx_ij = Vxx_ji = ½(T_ij + T_ji) and Vx = T's last column.
// What the design does about latency:
//   - the products are register-tiled: a thread owns a 4×4 tile (2×2 for
//     Quu; in the update, two rows of a tile beside the matching two
//     columns of its mirror) and reads each operand as one float4 (float2)
//     per step of the sum: two shared loads per 16 FMA. Each is in
//     outer-product form, both operands read along a row;
//   - the factor keeps row i of S in lane i's registers and every diagonal
//     in every lane (the same FMAs as the owning lane, so the same bits), so
//     a pivot is one rsqrt, one store of the column, one __syncwarp and
//     broadcast loads, with no shuffle and no branch between its loads;
//   - the right-hand side's column stays in registers through both
//     substitutions; the forward one goes a column of L at a time, so each
//     of its steps is one IEEE division by L_kk (as the reference) and one
//     FMA on the dependent chain; the gains are written in phase 4, by all
//     warps, not by the solving threads;
//   - the next knot's A, B, lxx, luu, lx, lu are staged into a second buffer
//     by the warps the solve leaves idle, so no device-memory read sits in a
//     dot loop or on the chain.
// Each sum runs over its index in ascending order and keeps its products'
// operands, as each phase's note says, so the bits do not depend on the
// schedule: tools/port_riccati_designs.py holds a new schedule to an
// earlier one's bits (max|new - old| = 0). A new sum order is a draw
// against the float64 bars: a descending back substitution moved K's
// reading from 1.397e-2 to 1.837e-2 (bar 3.122e-2). The factor and
// solve are instantiated for nu = 19 (H1, every guard folds away) and once,
// generically, for every other nu ≤ kMaxNu; everything else takes runtime
// sizes. Shared memory (smem_floats): 47,488 floats = 189,952 B at the
// limit (64, 32); 27,588 floats = 110,352 B for H1 (NXp=52, SA=52, NUp=20,
// SU=20).
//
// The wide design. At nx=103, nu=45 (H1 with hands) the layout above needs
// 456,032 B, twice what a block may use (232,448 B), so larger sizes take a
// second kernel with the same phases and the same tile functions, and
// three changes of layout (smem_floats_wide):
//   - the knot's A, B, lxx, luu, lx, lu are staged into a per-block scratch
//     buffer in global memory (two knots, padded and 16-byte aligned as the
//     shared buffers are, zeroed at the start of the launch) and read from
//     there, through L1 and L2 (13.1 MB for the hands pass at N=100, inside
//     the 50 MB L2);
//   - Qxx is written over [Vxx | Vx], which phase 1 has consumed, and the
//     update writes the new value function over Qxx in place: each round of
//     work items reads its T starting values, meets the others at a block
//     barrier, then writes (an entry is read and written by one work item,
//     or by the two halves of one pair, which share a round);
//   - [K | k] and P take the place of AᵀVxx once phase 2 is done (phase 2
//     forms every Qxx tile, none is left to phase 3), and L that of BᵀVxx
//     once Quu is formed.
// The factor runs in one warp with two rows per lane (rows i and i+32 in
// lane i, so nu ≤ 64); a pivot's diagonal comes from its owning lane by one
// shuffle (that lane's own value, the bits the carried diagonals give), the
// rest is the narrow factor: one rsqrt, one store of the column (zeros
// above the pivot and past nu), one __syncwarp, broadcast loads; the bump
// stays one warp-wide decision. The solve is the narrow one instantiated at
// nu = kMaxNuW with L's column stride 64. Shared memory at the limit
// (128, 64): 54,656 floats = 218,624 B; hands (NXp=104, SA=104, NUp=48,
// SU=48): 34,024 floats = 136,096 B; scratch 2 × (2·NXp·SA + NXp·SU +
// NUp·SU + NXp + NUp) floats per instance (232,640 B for hands).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNx = 64;
constexpr int kMaxNu = 32;
constexpr int kLs = kMaxNu;         // L's column stride
constexpr int kMaxNxW = 128;        // the wide design's limits
constexpr int kMaxNuW = 64;
constexpr int kLsW = kMaxNuW;       // L's column stride there
constexpr int kQuuThreads = 128;    // warps 0-3 form Quu
constexpr int kQTiles = 352;        // Qxu/Qxx tiles formed beside the factor
constexpr int kStageRows = 16;      // rows a warp stages per round
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Sizes: rows of nx-wide matrices have stride SA = round4(nx + 1) (the
// extra column holds Vx, Qu), rows of nu-wide ones stride SU = round4(nu);
// the 4×4 tiles run to NXp = round4(nx), NUp = round4(nu). Padding is
// zeroed once; no sum runs over a padded index, and padded outputs are
// never read into a valid one.
struct Dims {
  int nx, nu, NXp, NUp, SA, SU;
};

__host__ __device__ inline Dims dims(int nx, int nu) {
  return Dims{nx, nu, round4(nx), round4(nu), round4(nx + 1), round4(nu)};
}

struct Smem {
  float *VV;      // [Vxx | Vx]                       NXp × SA
  float *A, *lxx; // two knots' buffers each          2 · NXp × SA
  float *AtVT;    // (AᵀVxx)ᵀ                         NXp × SA
  float *QQ;      // Qxx                              NXp × SA
  float *R;       // [Qxuᵀ | Qu]                      NUp × SA
  float *X;       // [K | k]                          NUp × SA
  float *P;       // Quu·[K | k] + R                  NUp × SA
  float *B;       // two buffers                      2 · NXp × SU
  float *BtVT;    // (BᵀVxx)ᵀ                         NXp × SU
  float *luu;     // two buffers                      2 · NUp × SU
  float *Quu;     //                                  NUp × SU
  float *L;       // column-major, L_ik at k·kLs + i  kMaxNu × kLs
  float *lx, *Qx; // 2 · NXp, NXp
  float *lu;      // 2 · NUp
};

__host__ __device__ inline size_t smem_floats(const Dims& d) {
  return (size_t)d.SA * (7 * d.NXp + 3 * d.NUp) + (size_t)d.SU * (3 * d.NXp + 3 * d.NUp) +
         kMaxNu * kLs + 3 * d.NXp + 2 * d.NUp;
}

__device__ inline Smem carve(float* s, const Dims& d) {
  Smem m;
  const int xa = d.NXp * d.SA, ua = d.NUp * d.SA, xu = d.NXp * d.SU, uu = d.NUp * d.SU;
  m.VV = s; s += xa;
  m.A = s; s += 2 * xa;
  m.lxx = s; s += 2 * xa;
  m.AtVT = s; s += xa;
  m.QQ = s; s += xa;
  m.R = s; s += ua;
  m.X = s; s += ua;
  m.P = s; s += ua;
  m.B = s; s += 2 * xu;
  m.BtVT = s; s += xu;
  m.luu = s; s += 2 * uu;
  m.Quu = s; s += uu;
  m.L = s; s += kMaxNu * kLs;
  m.lx = s; s += 2 * d.NXp;
  m.Qx = s; s += d.NXp;
  m.lu = s;
  return m;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float e) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, e);
}

// Warps 0-3 meet here (named barrier 2): Quu is in shared memory.
__device__ __forceinline__ void quu_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"r"(kQuuThreads) : "memory");
}

// Knot t's inputs (A_t, B_t, lxx_t, luu_t, lx_t, lu_t) into buffer b by nw
// warps, the w-th of them first; tA and tX are the knot's indices into the
// arrays with N and with N + 1 knots per instance (b·N + t, b·(N+1) + t for
// instance b). Their rows form one list (3nx + nu + 2 rows of at most
// 32·kChunks floats, lanes along a row); a warp takes kRows rows at a time
// and issues all their loads before its stores. (A knot's slices are only
// 4-byte aligned, so 16-byte copies and TMA do not apply.)
template <int kRows = kStageRows, int kChunks = 2>
__device__ __forceinline__ void stage_knot(const Smem& s, const Dims& d, int b, size_t tA,
                                           size_t tX, int w, int nw,
                                           const float* __restrict__ A,
                                           const float* __restrict__ B,
                                           const float* __restrict__ lx,
                                           const float* __restrict__ lu,
                                           const float* __restrict__ lxx,
                                           const float* __restrict__ luu) {
  const int nx = d.nx, nu = d.nu, lane = threadIdx.x & 31;
  const int rows = 3 * nx + nu + 2;
  for (int q0 = w * kRows; q0 < rows; q0 += nw * kRows) {
    float v[kRows][kChunks];
    float* dst[kRows];
    int cols[kRows];
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const int q = q0 + m;
      const float* src = lu + tA * nu;
      dst[m] = s.lu + b * d.NUp;
      cols[m] = q == rows - 1 ? nu : 0;
      if (q < nx) {
        src = A + (tA * nx + q) * nx;
        dst[m] = s.A + (b * d.NXp + q) * d.SA;
        cols[m] = nx;
      } else if (q < 2 * nx) {
        src = B + (tA * nx + q - nx) * nu;
        dst[m] = s.B + (b * d.NXp + q - nx) * d.SU;
        cols[m] = nu;
      } else if (q < 3 * nx) {
        src = lxx + (tX * nx + q - 2 * nx) * nx;
        dst[m] = s.lxx + (b * d.NXp + q - 2 * nx) * d.SA;
        cols[m] = nx;
      } else if (q < 3 * nx + nu) {
        src = luu + (tA * nu + q - 3 * nx) * nu;
        dst[m] = s.luu + (b * d.NUp + q - 3 * nx) * d.SU;
        cols[m] = nu;
      } else if (q == 3 * nx + nu) {
        src = lx + tX * nx;
        dst[m] = s.lx + b * d.NXp;
        cols[m] = nx;
      }
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        v[m][c] = lane + 32 * c < cols[m] ? src[lane + 32 * c] : 0.f;
    }
#pragma unroll
    for (int m = 0; m < kRows; ++m)
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        if (lane + 32 * c < cols[m]) dst[m][lane + 32 * c] = v[m][c];
  }
}

// acc[a][b] += Σ_{k < nk} u_k[a] · v_k[b], u_k the four floats at u + k·ldu
// and v_k those at v + k·ldv (k ascending, one FMA per term).
__device__ __forceinline__ void outer_sum(float (&acc)[4][4], const float* u, int ldu,
                                          const float* v, int ldv, int nk) {
#pragma unroll 4
  for (int k = 0; k < nk; ++k) {
    const float4 p = ld4(u + k * ldu), q = ld4(v + k * ldv);
    const float ua[4] = {p.x, p.y, p.z, p.w}, vb[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(ua[a], vb[b], acc[a][b]);
  }
}

// Phase 1, tile w (all threads): BᵀVV, then AᵀVV, VV = [Vxx | Vx], in 4×4
// tiles. Writes BtVT, AtVT (transposed), Qu into R's last column and Qx.
__device__ __forceinline__ int vv_tiles(const Dims& d) {
  return (d.NUp / 4 + d.NXp / 4) * (d.SA / 4);
}

__device__ __forceinline__ void vv_tile(const Smem& s, const Dims& d, int w, const float* Ab,
                                        const float* Bb, const float* lxb, const float* lub) {
  const int G = d.SA / 4, RGu = d.NUp / 4;
  const int rg = w / G, cg = w - rg * G;
  const bool onB = rg < RGu;
  const int r0 = 4 * (onB ? rg : rg - RGu), c0 = 4 * cg, ld = onB ? d.SU : d.SA;
  float acc[4][4] = {};
  outer_sum(acc, (onB ? Bb : Ab) + r0, ld, s.VV + c0, d.SA, d.nx);
  float* T = (onB ? s.BtVT : s.AtVT) + r0;
  const int rows = onB ? d.nu : d.nx;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int j = c0 + b;
    if (j < d.nx) {
      st4(T + j * ld, acc[0][b], acc[1][b], acc[2][b], acc[3][b]);
    } else if (j == d.nx) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = r0 + a;
        if (r < rows) {
          if (onB) s.R[r * d.SA + d.nx] = lub[r] + acc[a][b];
          else s.Qx[r] = lxb[r] + acc[a][b];
        }
      }
    }
  }
}

// Phase 2a (warps 0-3): Quu = luu + (BᵀVxx)·B + λI in 2×2 tiles.
__device__ __forceinline__ void phase_quu(const Smem& s, const Dims& d, const float* Bb,
                                          const float* luub, float reg) {
  const int QG = d.NUp / 2;
  for (int tile = threadIdx.x; tile < QG * QG; tile += kQuuThreads) {
    const int r0 = 2 * (tile / QG), c0 = 2 * (tile % QG);
    float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
#pragma unroll 4
    for (int k = 0; k < d.nx; ++k) {
      const float2 u = ld2(s.BtVT + k * d.SU + r0), v = ld2(Bb + k * d.SU + c0);
      a00 = fmaf(u.x, v.x, a00);
      a01 = fmaf(u.x, v.y, a01);
      a10 = fmaf(u.y, v.x, a10);
      a11 = fmaf(u.y, v.y, a11);
    }
    const float acc[2][2] = {{a00, a01}, {a10, a11}};
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int r = r0 + a, c = c0 + b;
        if (r < d.nu && c < d.nu) {
          float q = luub[r * d.SU + c] + acc[a][b];
          if (r == c) q += reg;
          s.Quu[r * d.SU + c] = q;
        }
      }
  }
}

// Phase 2b, tile w: Qxu = (AᵀVxx)·B into R = Qxuᵀ (the first tiles, all of
// them among the first 128), then Qxx = lxx + (AᵀVxx)·A, 4×4 each.
__device__ __forceinline__ int q_tiles(const Dims& d) {
  return (d.NXp / 4) * (d.NUp / 4 + d.NXp / 4);
}

__device__ __forceinline__ void q_tile(const Smem& s, const Dims& d, int w, const float* Ab,
                                       const float* Bb, const float* lxxb) {
  const int RGu = d.NUp / 4, RGx = d.NXp / 4, n_xu = RGx * RGu;
  const bool xu = w < n_xu;
  const int ig = xu ? w / RGu : (w - n_xu) / RGx;
  const int cg = xu ? w - ig * RGu : (w - n_xu) - ig * RGx;
  const int i0 = 4 * ig, c0 = 4 * cg;
  float acc[4][4] = {};
  outer_sum(acc, s.AtVT + i0, d.SA, (xu ? Bb : Ab) + c0, xu ? d.SU : d.SA, d.nx);
  if (xu) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (i0 + a < d.nx && c0 + b < d.nu) s.R[(c0 + b) * d.SA + i0 + a] = acc[a][b];
  } else {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 l = ld4(lxxb + (i0 + a) * d.SA + c0);
      st4(s.QQ + (i0 + a) * d.SA + c0, l.x + acc[a][0], l.y + acc[a][1], l.z + acc[a][2],
          l.w + acc[a][3]);
    }
  }
}

// Cholesky of Quu (nu×nu) into L by warp 0, lane i on row i: right-looking,
// one pivot at a time, as _chol_masked. Row i of S stays in lane i's
// registers; every lane also carries all the diagonals S_jj, updated with
// the same FMAs as their own lanes, so pivot k reads its diagonal locally.
// L is stored column by column (L_ik at L[k·kLs + i]), so a pivot's column
// is one store per lane without bank conflicts; its entries past nu stay 0,
// so the update of a pivot runs over all kNu4 columns unguarded (no branch
// between its loads). Returns to every lane whether any entry of the factor
// is not finite — the reference's test, one value for the whole warp. With
// kFixed, nu is kNu and every guard folds away.
template <int kNu, bool kFixed>
__device__ __forceinline__ bool factor(const float* Quu, float* L, int nu_rt, int SU) {
  constexpr int kNu4 = round4(kNu);
  const int i = threadIdx.x, nu = kFixed ? kNu : nu_rt;
  float s[kNu4], dg[kNu4];
#pragma unroll
  for (int q = 0; q < kNu4; q += 4) {
    float4 row = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q < nu && i < nu) row = ld4(Quu + i * SU + q);
    s[q] = row.x, s[q + 1] = row.y, s[q + 2] = row.z, s[q + 3] = row.w;
  }
#pragma unroll
  for (int j = 0; j < kNu4; ++j) dg[j] = j < nu ? Quu[j * SU + j] : 0.f;
  bool bad = false;
#pragma unroll
  for (int k = 0; k < kNu; ++k) {
    if (k < nu) {  // warp-uniform
      const float l = s[k] * rsqrtf(dg[k]);
      if (i >= k && i < nu) {
        L[k * kLs + i] = l;
        bad |= !isfinite(l);
      }
      __syncwarp();
#pragma unroll
      for (int j = k + 1; j < kNu4; ++j) {
        const float ljk = L[k * kLs + j];
        s[j] = fmaf(-l, ljk, s[j]);
        dg[j] = fmaf(-ljk, ljk, dg[j]);
      }
    }
  }
  return __any_sync(kFull, bad);
}

// The wide design's factor of Quu (nu ≤ kMaxNuW) by warp 0: lane i holds
// rows i and i + 32 of S in registers. Pivot k takes its diagonal from the
// lane that owns row k (one shuffle: that lane's value, updated by the same
// FMAs the narrow factor's carried diagonals take), then as the narrow
// factor: one rsqrt, the column stored (L_ik at L[k·kLsW + i], zero above
// the pivot and past nu, so every later sum over it is exact zeros there),
// one __syncwarp, broadcast loads. Returns to every lane whether any entry
// of the factor is not finite, one value for the whole warp.
__device__ __forceinline__ bool factor_wide(const float* Quu, float* L, int nu, int SU) {
  constexpr int kNu4 = kMaxNuW;
  const int i = threadIdx.x;
  float s0[kNu4], s1[kNu4];
#pragma unroll
  for (int q = 0; q < kNu4; q += 4) {
    float4 r0 = make_float4(0.f, 0.f, 0.f, 0.f), r1 = r0;
    if (q < nu && i < nu) r0 = ld4(Quu + i * SU + q);
    if (q < nu && i + 32 < nu) r1 = ld4(Quu + (i + 32) * SU + q);
    s0[q] = r0.x, s0[q + 1] = r0.y, s0[q + 2] = r0.z, s0[q + 3] = r0.w;
    s1[q] = r1.x, s1[q + 1] = r1.y, s1[q + 2] = r1.z, s1[q + 3] = r1.w;
  }
  bool bad = false;
#pragma unroll
  for (int k = 0; k < kMaxNuW; ++k) {
    if (k < nu) {  // warp-uniform
      const float r = rsqrtf(__shfl_sync(kFull, k < 32 ? s0[k] : s1[k], k & 31));
      const float l0 = s0[k] * r, l1 = s1[k] * r;
      const bool v0 = i >= k && i < nu, v1 = i + 32 >= k && i + 32 < nu;
      L[k * kLsW + i] = v0 ? l0 : 0.f;
      L[k * kLsW + i + 32] = v1 ? l1 : 0.f;
      bad |= (v0 && !isfinite(l0)) || (v1 && !isfinite(l1));
      __syncwarp();
#pragma unroll
      for (int j = k + 1; j < kNu4; ++j) {
        const float ljk = L[k * kLsW + j];
        s0[j] = fmaf(-l0, ljk, s0[j]);
        s1[j] = fmaf(-l1, ljk, s1[j]);
      }
    }
  }
  return __any_sync(kFull, bad);
}

// Phase 3 (thread c ≤ nx): column c of X = −(L Lᵀ)⁻¹ R, the column in
// registers, L read as broadcasts, each step ending in an IEEE division by
// L_kk (as the reference). The forward substitution goes a column of L at
// a time: once y_k is divided out, every later row takes its term at once,
// so a step's dependent chain is one division and one FMA, and each row
// still adds its terms in ascending order. The back substitution adds
// x_{k+1} .. x_{nu-1} in ascending order. Then X and column c of
// P = Quu·X + R, four rows at a time; k's column of P is Quu·k + Qu summed
// from Qu, the others Quu·K summed from 0 plus Qxuᵀ. Entries of x past nu
// stay 0 (the forward pass is guarded there), as do L's and Quu's, so the
// sums over them add exact zeros.
template <int kNu, bool kFixed, int kL = kLs>
__device__ __forceinline__ void phase_solve(const Smem& s, const Dims& d) {
  constexpr int kNu4 = round4(kNu);
  const int c = threadIdx.x, SU = d.SU, SA = d.SA;
  const int nu = kFixed ? kNu : d.nu, nu4 = kFixed ? kNu4 : round4(d.nu);
  float x[kNu4];
#pragma unroll
  for (int k = 0; k < kNu4; ++k) x[k] = k < nu ? s.R[k * SA + c] : 0.f;
#pragma unroll
  for (int k = 0; k < kNu; ++k)
    if (k < nu) {
      x[k] = x[k] / s.L[k * kL + k];
#pragma unroll
      for (int j = k + 1; j < kNu; ++j)
        if (j < nu) x[j] = fmaf(-s.L[k * kL + j], x[k], x[j]);
    }
#pragma unroll
  for (int k = kNu - 1; k >= 0; --k)
    if (k < nu) {
      float v = x[k];
#pragma unroll
      for (int j = k + 1; j < kNu; ++j) v = fmaf(-s.L[k * kL + j], x[j], v);
      x[k] = v / s.L[k * kL + k];
    }
#pragma unroll
  for (int k = 0; k < kNu4; ++k) {
    x[k] = -x[k];
    if (k < nu) s.X[k * SA + c] = x[k];
  }
  const bool kcol = c == d.nx;  // k's column starts from Qu, as Quu·k + Qu
  for (int r0 = 0; r0 < nu4; r0 += 4) {
    float acc[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) acc[a] = kcol ? s.R[(r0 + a) * SA + c] : 0.f;
#pragma unroll
    for (int q = 0; q < kNu4; q += 4)
      if (q < nu)
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float4 qr = ld4(s.Quu + (r0 + a) * SU + q);
          acc[a] = fmaf(qr.x, x[q], acc[a]);
          acc[a] = fmaf(qr.y, x[q + 1], acc[a]);
          acc[a] = fmaf(qr.z, x[q + 2], acc[a]);
          acc[a] = fmaf(qr.w, x[q + 3], acc[a]);
        }
#pragma unroll
    for (int a = 0; a < 4; ++a)
      s.P[(r0 + a) * SA + c] = kcol ? acc[a] : acc[a] + s.R[(r0 + a) * SA + c];
  }
}

// K_t and k_t from X (all threads, coalesced); tA as in stage_knot.
__device__ __forceinline__ void write_gains(const Smem& s, const Dims& d, size_t tA,
                                            float* __restrict__ K, float* __restrict__ kff) {
  const int nx = d.nx, nu = d.nu;
  for (int e = threadIdx.x; e < nu * (nx + 1); e += kThreads) {
    const int r = e / (nx + 1), c = e - r * (nx + 1);
    const float v = s.X[r * d.SA + c];
    if (c < nx) K[(tA * nu + r) * nx + c] = v;
    else kff[tA * nu + r] = v;
  }
}

// T_ij's starting value: Qxx_ij, or Qx_i in the Vx column.
__device__ __forceinline__ float t0(const Smem& s, const Dims& d, int i, int j) {
  if (i >= d.nx) return 0.f;
  return j < d.nx ? s.QQ[i * d.SA + j] : (j == d.nx ? s.Qx[i] : 0.f);
}

// Phase 4 (all threads): T = Qxx + Xᵀ P + Rᵀ X over [Vxx | Vx], a term
// T += X_ri·P_rj + R_ri·X_rj per r, in that form. A work item
// is half of a pair of 4×4 tiles (I, J), I ≤ J: rows 4I+2h, 4I+2h+1 of tile
// (I, J) beside columns 4I+2h, 4I+2h+1 of tile (J, I), so one thread holds
// T_ij and T_ji and writes Vxx_ij = Vxx_ji = ½(T_ij + T_ji); the Vx column
// (j = nx) is written as it stands.
__device__ __forceinline__ void phase_update(const Smem& s, const Dims& d) {
  const int RG = d.NXp / 4, G = d.SA / 4, SA = d.SA;
  const int n_pairs = RG * G - RG * (RG - 1) / 2;
  for (int w = threadIdx.x; w < 2 * n_pairs; w += kThreads) {
    int p = w >> 1, I = 0;
    while (p >= G - I) p -= G - I++;
    const int J = I + p, i0 = 4 * I + 2 * (w & 1), j0 = 4 * J;
    float t1[2][4], t2[4][2];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        t1[a][b] = t0(s, d, i0 + a, j0 + b);
        t2[b][a] = t0(s, d, j0 + b, i0 + a);
      }
#pragma unroll 4
    for (int r = 0; r < d.nu; ++r) {
      const float* Xr = s.X + r * SA;
      const float* Pr = s.P + r * SA;
      const float* Rr = s.R + r * SA;
      const float2 xi2 = ld2(Xr + i0), pi2 = ld2(Pr + i0), ri2 = ld2(Rr + i0);
      const float4 xj4 = ld4(Xr + j0), pj4 = ld4(Pr + j0), rj4 = ld4(Rr + j0);
      const float xi[2] = {xi2.x, xi2.y}, pi[2] = {pi2.x, pi2.y}, ri[2] = {ri2.x, ri2.y};
      const float xj[4] = {xj4.x, xj4.y, xj4.z, xj4.w}, pj[4] = {pj4.x, pj4.y, pj4.z, pj4.w},
                  rj[4] = {rj4.x, rj4.y, rj4.z, rj4.w};
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          t1[a][b] += xi[a] * pj[b] + ri[a] * xj[b];
          t2[b][a] += xj[b] * pi[a] + rj[b] * xi[a];
        }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = i0 + a, j = j0 + b;
        if (i < d.nx && j < d.nx) {
          const float v = 0.5f * (t1[a][b] + t2[b][a]);
          s.VV[i * SA + j] = v;
          if (I != J) s.VV[j * SA + i] = v;
        } else if (i < d.nx && j == d.nx) {
          s.VV[i * SA + j] = t1[a][b];
        }
      }
  }
}

// Phase 4 of the wide design: phase_update's work items, with T's starting
// values read from Qxx where the new [Vxx | Vx] is written. Each round of
// kThreads items reads its starting values, meets the block at a barrier,
// then sums and writes. An off-diagonal entry belongs to one item, and the
// two halves of a diagonal tile's pair (items 2p, 2p+1) share a round, so
// no write lands on a value another item has yet to read.
__device__ __forceinline__ void phase_update_inplace(const Smem& s, const Dims& d) {
  const int RG = d.NXp / 4, G = d.SA / 4, SA = d.SA;
  const int n_items = 2 * (RG * G - RG * (RG - 1) / 2);
  for (int w0 = 0; w0 < n_items; w0 += kThreads) {
    const int w = w0 + threadIdx.x;
    const bool on = w < n_items;
    int I = 0, J = 0, i0 = 0, j0 = 0;
    float t1[2][4], t2[4][2];
    if (on) {
      int p = w >> 1;
      while (p >= G - I) p -= G - I++;
      J = I + p, i0 = 4 * I + 2 * (w & 1), j0 = 4 * J;
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          t1[a][b] = t0(s, d, i0 + a, j0 + b);
          t2[b][a] = t0(s, d, j0 + b, i0 + a);
        }
    }
    __syncthreads();
    if (!on) continue;
#pragma unroll 4
    for (int r = 0; r < d.nu; ++r) {
      const float* Xr = s.X + r * SA;
      const float* Pr = s.P + r * SA;
      const float* Rr = s.R + r * SA;
      const float2 xi2 = ld2(Xr + i0), pi2 = ld2(Pr + i0), ri2 = ld2(Rr + i0);
      const float4 xj4 = ld4(Xr + j0), pj4 = ld4(Pr + j0), rj4 = ld4(Rr + j0);
      const float xi[2] = {xi2.x, xi2.y}, pi[2] = {pi2.x, pi2.y}, ri[2] = {ri2.x, ri2.y};
      const float xj[4] = {xj4.x, xj4.y, xj4.z, xj4.w}, pj[4] = {pj4.x, pj4.y, pj4.z, pj4.w},
                  rj[4] = {rj4.x, rj4.y, rj4.z, rj4.w};
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          t1[a][b] += xi[a] * pj[b] + ri[a] * xj[b];
          t2[b][a] += xj[b] * pi[a] + rj[b] * xi[a];
        }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = i0 + a, j = j0 + b;
        if (i < d.nx && j < d.nx) {
          const float v = 0.5f * (t1[a][b] + t2[b][a]);
          s.VV[i * SA + j] = v;
          if (I != J) s.VV[j * SA + i] = v;
        } else if (i < d.nx && j == d.nx) {
          s.VV[i * SA + j] = t1[a][b];
        }
      }
  }
}

template <int kNu, bool kFixed>
__global__ void __launch_bounds__(kThreads, 1)
riccati_backward(const float* __restrict__ A, const float* __restrict__ B,
                 const float* __restrict__ lx, const float* __restrict__ lu,
                 const float* __restrict__ lxx, const float* __restrict__ luu,
                 const float* __restrict__ reg_ptr, float pd_bump, float* __restrict__ K,
                 float* __restrict__ kff, int N, int nx, int nu) {
  extern __shared__ __align__(16) float smem[];
  const Dims d = dims(nx, nu);
  const Smem s = carve(smem, d);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int xa = d.NXp * d.SA, xu = d.NXp * d.SU, uu = d.NUp * d.SU;
  const int n_vv = vv_tiles(d), n_q = q_tiles(d);
  const int w_stage = (nx + 32) / 32;  // the first warp with no column to solve
  const int n_stage = kThreads / 32 - w_stage;
  const size_t bN = (size_t)blockIdx.x * N, bN1 = bN + blockIdx.x;  // this instance's knots
  const float reg = reg_ptr[blockIdx.x];

  float4* z = reinterpret_cast<float4*>(smem);
  for (size_t e = tid; e < smem_floats(d) / 4; e += kThreads) z[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  stage_knot(s, d, (N - 1) & 1, bN + N - 1, bN1 + N - 1, warp, kThreads / 32, A, B, lx, lu,
             lxx, luu);
  for (int e = tid; e < nx * nx; e += kThreads)
    s.VV[(e / nx) * d.SA + e % nx] = lxx[(bN1 + N) * nx * nx + e];
  for (int e = tid; e < nx; e += kThreads) s.VV[e * d.SA + nx] = lx[(bN1 + N) * nx + e];
  __syncthreads();

  for (int t = N - 1; t >= 0; --t) {
    const int b = t & 1;
    const float *Ab = s.A + b * xa, *Bb = s.B + b * xu, *lxxb = s.lxx + b * xa;

    for (int w = tid; w < n_vv; w += kThreads)
      vv_tile(s, d, w, Ab, Bb, s.lx + b * d.NXp, s.lu + b * d.NUp);
    __syncthreads();

    // Quu on warps 0-3, then its factor on warp 0. Beside them warps 4-7
    // form Qxu/Qxx tiles 0-127 (every Qxu tile among them) and 224-351, and
    // once Quu is done, warps 1-3 tiles 128-223.
    if (tid < kQuuThreads) {
      phase_quu(s, d, Bb, s.luu + b * uu, reg);
      quu_sync();
      if (tid < 32) {
        if (factor<kNu, kFixed>(s.Quu, s.L, nu, d.SU)) {  // warp-uniform
          if (tid < nu) s.Quu[tid * d.SU + tid] += pd_bump;
          __syncwarp();
          factor<kNu, kFixed>(s.Quu, s.L, nu, d.SU);
        }
      } else if (96 + tid < n_q) {
        q_tile(s, d, 96 + tid, Ab, Bb, lxxb);
      }
    } else {
      for (int w = tid - kQuuThreads; w < min(n_q, kQTiles); w += 224)
        q_tile(s, d, w, Ab, Bb, lxxb);
    }
    __syncthreads();

    // The solve on the first warps; beside it the others form the Qxx tiles
    // left over and stage knot t - 1.
    if (tid <= nx) {
      phase_solve<kNu, kFixed>(s, d);
    } else if (warp >= w_stage) {
      for (int w = kQTiles + tid - 32 * w_stage; w < n_q; w += 32 * n_stage)
        q_tile(s, d, w, Ab, Bb, lxxb);
      if (t > 0)
        stage_knot(s, d, (t - 1) & 1, bN + t - 1, bN1 + t - 1, warp - w_stage, n_stage, A, B,
                   lx, lu, lxx, luu);
    }
    __syncthreads();

    write_gains(s, d, bN + t, K, kff);
    phase_update(s, d);
    __syncthreads();
  }
}

// The wide design (see the header): Smem's knot buffers (A, lxx, B, luu, lx,
// lu) point into the block's scratch in global memory; QQ is VV, X and P
// share AtVT's place, L BtVT's.
__host__ __device__ inline size_t smem_floats_wide(const Dims& d) {
  const size_t xa = (size_t)d.NXp * d.SA, ua = (size_t)d.NUp * d.SA;
  const size_t xu = (size_t)d.NXp * d.SU, uu = (size_t)d.NUp * d.SU;
  return 2 * xa + (2 * ua > xa ? 2 * ua - xa : 0) + ua + (xu > d.NUp * kLsW ? xu : d.NUp * kLsW) +
         uu + d.NXp;
}

__host__ __device__ inline size_t scratch_floats_wide(const Dims& d) {
  return 2 * ((size_t)2 * d.NXp * d.SA + (size_t)d.NXp * d.SU + (size_t)d.NUp * d.SU + d.NXp +
              d.NUp);
}

__device__ inline Smem carve_wide(float* s, float* g, const Dims& d) {
  Smem m;
  const int xa = d.NXp * d.SA, ua = d.NUp * d.SA, xu = d.NXp * d.SU, uu = d.NUp * d.SU;
  m.VV = m.QQ = s; s += xa;
  m.AtVT = m.X = s;
  m.P = s + ua; s += max(xa, 2 * ua);
  m.R = s; s += ua;
  m.BtVT = m.L = s; s += max(xu, d.NUp * kLsW);
  m.Quu = s; s += uu;
  m.Qx = s;
  m.A = g; g += 2 * xa;
  m.lxx = g; g += 2 * xa;
  m.B = g; g += 2 * xu;
  m.luu = g; g += 2 * uu;
  m.lx = g; g += 2 * d.NXp;
  m.lu = g;
  return m;
}

__global__ void __launch_bounds__(kThreads, 1)
riccati_backward_wide(const float* __restrict__ A, const float* __restrict__ B,
                      const float* __restrict__ lx, const float* __restrict__ lu,
                      const float* __restrict__ lxx, const float* __restrict__ luu,
                      const float* __restrict__ reg_ptr, float pd_bump, float* __restrict__ K,
                      float* __restrict__ kff, float* scratch, int N, int nx, int nu) {
  extern __shared__ __align__(16) float smem[];
  const Dims d = dims(nx, nu);
  float* g = scratch + blockIdx.x * scratch_floats_wide(d);
  const Smem s = carve_wide(smem, g, d);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int xa = d.NXp * d.SA, xu = d.NXp * d.SU, uu = d.NUp * d.SU;
  const int n_vv = vv_tiles(d), n_q = q_tiles(d);
  const int w_stage = (nx + 32) / 32;  // the first warp with no column to solve
  const int n_stage = kThreads / 32 - w_stage;
  const size_t bN = (size_t)blockIdx.x * N, bN1 = bN + blockIdx.x;
  const float reg = reg_ptr[blockIdx.x];

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (size_t e = tid; e < smem_floats_wide(d) / 4; e += kThreads)
    reinterpret_cast<float4*>(smem)[e] = zero;
  for (size_t e = tid; e < scratch_floats_wide(d) / 4; e += kThreads)
    reinterpret_cast<float4*>(g)[e] = zero;
  __syncthreads();
  stage_knot<8, 4>(s, d, (N - 1) & 1, bN + N - 1, bN1 + N - 1, warp, kThreads / 32, A, B, lx,
                   lu, lxx, luu);
  for (int e = tid; e < nx * nx; e += kThreads)
    s.VV[(e / nx) * d.SA + e % nx] = lxx[(bN1 + N) * nx * nx + e];
  for (int e = tid; e < nx; e += kThreads) s.VV[e * d.SA + nx] = lx[(bN1 + N) * nx + e];
  __syncthreads();

  for (int t = N - 1; t >= 0; --t) {
    const int b = t & 1;
    const float *Ab = s.A + b * xa, *Bb = s.B + b * xu, *lxxb = s.lxx + b * xa;

    for (int w = tid; w < n_vv; w += kThreads)
      vv_tile(s, d, w, Ab, Bb, s.lx + b * d.NXp, s.lu + b * d.NUp);
    __syncthreads();

    // Quu on warps 0-3, then its factor on warp 0; every Qxu/Qxx tile on
    // warps 4-7 and, once Quu is done, warps 1-3.
    if (tid < kQuuThreads) {
      phase_quu(s, d, Bb, s.luu + b * uu, reg);
      quu_sync();
    }
    if (tid < 32) {
      if (factor_wide(s.Quu, s.L, nu, d.SU)) {  // warp-uniform
        for (int r = tid; r < nu; r += 32) s.Quu[r * d.SU + r] += pd_bump;
        __syncwarp();
        factor_wide(s.Quu, s.L, nu, d.SU);
      }
    } else {
      for (int w = tid - 32; w < n_q; w += kThreads - 32) q_tile(s, d, w, Ab, Bb, lxxb);
    }
    __syncthreads();

    // The solve on the first warps; beside it the others stage knot t - 1.
    if (tid <= nx) {
      phase_solve<kMaxNuW, false, kLsW>(s, d);
    } else if (warp >= w_stage && t > 0) {
      stage_knot<8, 4>(s, d, (t - 1) & 1, bN + t - 1, bN1 + t - 1, warp - w_stage, n_stage, A,
                       B, lx, lu, lxx, luu);
    }
    __syncthreads();

    write_gains(s, d, bN + t, K, kff);
    phase_update_inplace(s, d);
    __syncthreads();
  }
}

// Above 48 KB a block's shared memory must be opted into (227 KB max).
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int kNu, bool kFixed>
int launch(const float* A, const float* B, const float* lx, const float* lu, const float* lxx,
           const float* luu, const float* reg, float pd_bump, float* K, float* kff, int batch,
           int N, int nx, int nu, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(dims(nx, nu));
  cudaError_t e = opt_in(riccati_backward<kNu, kFixed>, bytes);
  if (e != cudaSuccess) return (int)e;
  riccati_backward<kNu, kFixed><<<batch, kThreads, bytes, stream>>>(A, B, lx, lu, lxx, luu, reg,
                                                                    pd_bump, K, kff, N, nx, nu);
  return (int)cudaGetLastError();
}

bool narrow(int nx, int nu) { return nx <= kMaxNx && nu <= kMaxNu; }

}  // namespace

extern "C" {

// Shared memory per block, and global scratch per instance (floats), of the
// design that takes (nx, nu).
long long mpc_riccati_smem_bytes(int nx, int nu) {
  const Dims d = dims(nx, nu);
  return (long long)(sizeof(float) * (narrow(nx, nu) ? smem_floats(d) : smem_floats_wide(d)));
}

long long mpc_riccati_scratch_floats(int nx, int nu) {
  return narrow(nx, nu) ? 0 : (long long)scratch_floats_wide(dims(nx, nu));
}

// K (batch, N, nu, nx), kff (batch, N, nu) from A (batch, N, nx, nx),
// B (batch, N, nx, nu), lx (batch, N+1, nx), lu (batch, N, nu),
// lxx (batch, N+1, nx, nx), luu (batch, N, nu, nu) and λ (batch,), all
// row-major float32 on the device (no host read of λ); one block per
// instance. `scratch` holds batch · mpc_riccati_scratch_floats(nx, nu)
// floats on the device (unused, and may be null, for the narrow design).
int mpc_riccati_backward_batched(const float* A, const float* B, const float* lx,
                                 const float* lu, const float* lxx, const float* luu,
                                 const float* reg, float pd_bump, float* K, float* kff,
                                 float* scratch, int batch, int N, int nx, int nu, void* stream) {
  if (batch < 1 || N < 1 || nx < 1 || nu < 1 || nx > kMaxNxW || nu > kMaxNuW)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (nu == 19 && nx <= kMaxNx)  // H1
    return launch<19, true>(A, B, lx, lu, lxx, luu, reg, pd_bump, K, kff, batch, N, nx, nu, st);
  if (narrow(nx, nu))
    return launch<kMaxNu, false>(A, B, lx, lu, lxx, luu, reg, pd_bump, K, kff, batch, N, nx, nu,
                                 st);
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * smem_floats_wide(dims(nx, nu));
  cudaError_t e = opt_in(riccati_backward_wide, bytes);
  if (e != cudaSuccess) return (int)e;
  riccati_backward_wide<<<batch, kThreads, bytes, st>>>(A, B, lx, lu, lxx, luu, reg, pd_bump, K,
                                                         kff, scratch, N, nx, nu);
  return (int)cudaGetLastError();
}

// One instance (the batched launch with batch = 1), for the sizes every
// design of this kernel takes (nx <= 64, nu <= 32; tools/port_riccati_designs.py).
int mpc_riccati_backward(const float* A, const float* B, const float* lx, const float* lu,
                         const float* lxx, const float* luu, const float* reg, float pd_bump,
                         float* K, float* kff, int N, int nx, int nu, void* stream) {
  if (!narrow(nx, nu)) return (int)cudaErrorInvalidValue;
  return mpc_riccati_backward_batched(A, B, lx, lu, lxx, luu, reg, pd_bump, K, kff, nullptr, 1, N,
                                      nx, nu, stream);
}

}  // extern "C"
