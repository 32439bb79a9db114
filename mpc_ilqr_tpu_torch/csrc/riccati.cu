// The Riccati backward pass for Hopper (sm_90a): the whole recursion
// t = N-1 .. 0 in one launch, the value function (Vx, Vxx) in shared memory
// for the whole pass.
//
//   riccati_backward       replaces the TPU kernel backward_pass_pallas
//                          (mpc_ilqr_tpu/ops/riccati.py:143; body
//                          _riccati_kernel :94, _chol_masked :43,
//                          _solve_chol :67) for nx <= 64, nu <= 32: one
//                          thread block per instance
//   riccati_backward_wide  the same for every larger size up to
//                          nx <= kMaxNxW = 160, nu <= kMaxNuW = 80: one
//                          thread-block cluster of C CTAs per instance
//
// A launch covers a batch of instances, one block (one cluster) each: block
// (cluster) b reads its instance's inputs at stride, its λ from reg[b], and
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
// as rsqrt does on the TPU; the bump is one decision over the whole factor.
// Nothing is clamped or skipped. Full fp32 throughout (no TF32).
//
// The narrow design. Bound on this card (H1: nx=51, nu=19; counts from
// chip_smoke.py's riccati_flops, one triangle of each symmetric result): about 0.81 Mflop
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
// The wide design. At nx=103, nu=45 (H1 with hands) the narrow layout needs
// 456,032 B, twice what a block may use (232,448 B), so an instance runs on
// a thread-block cluster of C CTAs, launched with cudaLaunchKernelEx and a
// cluster dimension, grid = C · batch. A CTA has 384 threads: a 4×4 tile
// each covers every product of a hands knot in one round, and 168 registers
// a thread keep the factor and the substitutions from spilling (512
// threads, at 128 registers, spilled). The host takes the smallest C of 4,
// 8 whose CTAs hold the working set (wide_cluster: 4 at (103, 45) and
// (128, 64), 8 at (160, 80)). Two CTAs hold the hands sizes too, but four
// measured faster there (tools/port_riccati_phases.py --cluster 2 against
// --cluster 4, a probe build pinned to each size: the products halve per
// CTA, the pushes grow), hence kMinCluster; the launch takes no other size.
// kMaxNxW and kMaxNuW are where the working set stops fitting:
// every size up to (160, 80) fits 8 CTAs, (161, 80) and (160, 81) fit none.
// Bound on this card (hands, N=100, chip_smoke.py's counts): 729.9 Mflop,
// 10.9 µs at 67 TFLOP/s; as in the narrow design the serial recursion makes
// the pass latency-bound: per knot about 1.2 M FMA on each of four SMs,
// around a factor and two substitutions that are serial within their
// blocks, and ten cluster barriers.
//
// Who holds what. The columns [0, SA) of the nx-wide matrices (nx + 1 valid:
// the last is Vx, Qu or k) are cut into C blocks of whole 4-column groups,
// the columns [0, NUp) of the nu-wide ones likewise (WDims). Rank c holds in
// its own shared memory, double-buffered, the columns of the knot's A and
// lxx in its x block and of B and luu in its u block, with lx and lu there:
// every knot input it consumes and nothing else. Each CTA also holds F, one
// replicated buffer as large as [Vxx | Vx], whose content changes through
// the knot: VV = [Vxx | Vx], Wᵀ (W = AᵀVxx), Yᵀ (Y = BᵀVxx), then Quu and
// its factor L, then X = [K | k] and R = [Qxuᵀ | Qu], then T. A CTA forms
// the blocks of the products it owns into local buffers and all-gathers
// them: it writes each block into every CTA's F through distributed shared
// memory (cluster.map_shared_rank), between two cluster.sync()s, the first
// when no CTA reads F's old content any more, the second before anyone
// reads the new. Per knot t, ten cluster barriers:
//   1. W's rows on the x block and Y's on the u block from VV (all tiles of
//      both in one loop); their Vx column gives Qx and Qu, written into
//      every CTA's replicated Qx, Qu; barrier, push Wᵀ, barrier;
//   2a. Qxx's x block = lxx + W·A (Wᵀ from F, A local), over the W block;
//      barrier, push Yᵀ, barrier;
//   2b. R's x block = Y·A, its Vx column Qu (Qxuᵀ = BᵀVxxA; Vxx is
//      symmetric, so this is AᵀVxxB's transpose), and Quu's u block =
//      luu + Y·B + λI; barrier, push Quu, barrier;
//   3. every CTA factors the whole Quu and with it runs the forward
//      substitution of its x block of R (below), so each takes the same bump
//      decision on the same bits with one block-wide OR and no cluster-wide
//      one; then the back substitution gives its block of X = −Quu⁻¹R; it
//      writes its columns of K_t, k_t and forms its block of P = Quu·X + R
//      (k's column summed from Qu); barrier, push X and R, barrier;
//   4. T's x block = Qxx + XᵀP + RᵀX (X, R from F; P, X local), the Vx
//      column started from Qx, over the Qxx block; barrier, push T,
//      barrier; then each CTA symmetrizes its own F, Vxx = ½(T + Tᵀ), with
//      the same operations, so every copy holds the same bits.
// The last access to another CTA's memory in a knot precedes its last
// barrier, so no CTA exits or overwrites a buffer while a peer reads it.
// The products are the narrow design's register tiles: a thread owns a 4×4
// tile, reads each operand as one float4 per step of the sum (both along a
// row, outer-product form), and the lanes of a warp take neighbouring
// column groups of the operand in F while sharing the local one (a
// broadcast).
//
// The copies (KnotCopy). The inputs of knot t − 1 come into the other
// buffer while knot t computes. A row of A at nx=103 is 412 B and A_k sits
// at k·42,436 B: 4-byte aligned only, which allows no copy wider than 4
// bytes. Of the two ways in, 4-byte cp.async with commit groups and padded
// rows with tensor copies, the design takes the second: 4-byte cp.async of
// a knot stalled its issuing warps ~11k cycles per knot
// (tools/port_riccati_phases.py). So ops/riccati.py pads every row to a
// multiple of 4 floats (pad_rows: ~13 MB more read and written per call at
// (100, 103, 45), inside the op's call), and the kernel takes the knot by
// TMA: thread 0 issues six 2-D tensor boxes per knot (cuTensorMapEncodeTiled
// on the host, the maps passed as a __grid_constant__ parameter),
// completing on the buffer's mbarrier, which every thread waits on before
// the knot. A launch on rows that are not 16-byte aligned, or whose maps do
// not encode, is refused with cudaErrorInvalidValue (the batched entry on
// unpadded rows at an nx or nu that is not a multiple of 4, for one). One
// bulk copy per row was tried first: the TMA unit took ~80 cycles per
// 200-byte row, and the issuing warp stalled ~28k cycles per knot.
//
// The factor (factor_blocked) goes by panels of kPanel = 16 columns: warp 0
// factors the diagonal block (a row per lane, the pivot's diagonal by a
// shuffle from its own lane, L_jk by shuffles), one thread per row below
// solves its panel row with the block's rsqrt per pivot, one thread per
// right-hand side its entries of the panel (the forward substitution: each
// step an IEEE division by L_kk, as the reference, through div_rn, which
// keeps a zero numerator off the division's slow path), and all threads
// apply the panel to the trailing lower triangle and the right-hand sides.
// Each entry takes its pivots' terms one fmaf at a time in ascending order,
// L_ik = S_ik·rsqrt(S_kk) and y_k = v_k / L_kk: the right-looking factor's
// and the forward substitution's own operations, so the factor has the
// bits of the pivot-by-pivot one and NaN or inf where it does; the bump is
// one decision over the whole factor, and with it both start again from Quu
// and R. The back substitution (back_blocked) goes up by blocks of 16 rows:
// one thread per local column solves the diagonal block with the column in
// registers (IEEE divisions again; no inverse of the block), then all
// threads update the rows above as a product. It adds each row's terms in
// descending k where the narrow solve goes ascending: a blocked back
// substitution cannot keep that order without going serial again, and the
// float64 bars are held on the card. The other sum orders: every product
// sums k ascending with one fmaf per term; Qxuᵀ is Y·A where the narrow
// design forms (AᵀVxx)·B; T takes its XᵀP and RᵀX terms as two fmafs per r.
// The serial loops (the diagonal blocks) are rolled, with the row in
// registers shifted by one column per step, so a warp's chain runs from a
// small loop body.
//
// Shared memory per CTA (wide_floats): F = max(NXp·SA, nx·NUp, 2·NUp²,
// 2·NUp·SA), two knot buffers (each array on 128 bytes, where a tensor box
// lands), the W/Qxx/T block SA·wxm, the Y/Quu/X+P blocks, the R block
// NUp·wxm, Qx, Qu, the pivots' rsqrt and two mbarriers. Hands (NXp=104,
// SA=104, NUp=48), C=4, wxm=28, wum=12: 133,680 B (C=2: 212,016 B); the
// limit (160, 80), C=8, wxm=24, wum=12: 230,176 B. No global scratch.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNx = 64;
constexpr int kMaxNu = 32;
constexpr int kLs = kMaxNu;         // L's column stride
constexpr int kMaxNxW = 160;        // the wide design's limits: every size up to
constexpr int kMaxNuW = 80;         // them fits a cluster of at most kMaxCluster CTAs
constexpr int kThreadsW = 384;      // threads per CTA of the wide design
constexpr int kMaxCluster = 8;      // the portable maximum
constexpr int kMinCluster = 4;      // 2 CTAs hold the hands sizes, 4 measured faster there
constexpr int kPanel = 16;          // the wide factor's panel and the solve's block
constexpr int kPanelRows = 64;      // threads for the rows below a panel (nu - 16 at most)
constexpr size_t kMaxSmemBytes = 232448;  // shared memory a block may use
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
template <int kNu, bool kFixed>
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
      x[k] = x[k] / s.L[k * kLs + k];
#pragma unroll
      for (int j = k + 1; j < kNu; ++j)
        if (j < nu) x[j] = fmaf(-s.L[k * kLs + j], x[k], x[j]);
    }
#pragma unroll
  for (int k = kNu - 1; k >= 0; --k)
    if (k < nu) {
      float v = x[k];
#pragma unroll
      for (int j = k + 1; j < kNu; ++j) v = fmaf(-s.L[k * kLs + j], x[j], v);
      x[k] = v / s.L[k * kLs + k];
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

// ---- The wide design: one thread-block cluster per instance (see the header) ----

namespace cg = cooperative_groups;

// Phase stamps of the wide kernel: empty here; tools/port_riccati_phases.py
// defines them in a probe copy (clock64 by thread 0 of the first CTA).
#ifndef RICCATI_STAMP
#define RICCATI_STAMP_START
#define RICCATI_STAMP(i)
#endif

// Sizes of the wide design for a cluster of C CTAs. The columns [0, SA) of
// the nx-wide matrices (nx + 1 of them valid: the last is Vx, Qu or k) are cut
// into C blocks of whole 4-column groups, rank c taking groups
// [c·G/C, (c+1)·G/C); the columns [0, NUp) of the nu-wide ones likewise.
// wxm and wum are the widest blocks, the local buffers' row strides.
struct WDims {
  int nx, nu, NXp, NUp, SA, C, wxm, wum;
};

// The first column of rank c's block among `groups` 4-column groups.
__host__ __device__ inline int block_start(int groups, int C, int c) {
  return 4 * (c * groups / C);
}

__host__ __device__ inline size_t max2(size_t a, size_t b) { return a > b ? a : b; }

// One knot's inputs as rank c holds them: the columns of A and lxx in its x
// block, of B and luu in its u block, and lx, lu there (row strides wxm, wum).
__host__ __device__ inline size_t round32(size_t n) { return (n + 31) & ~(size_t)31; }

// (Each array starts on 128 bytes, where a tensor copy may land.)
__host__ __device__ inline size_t knot_floats(const WDims& w) {
  return round32((size_t)w.nx * w.wxm) + round32((size_t)w.NXp * w.wxm) +
         round32((size_t)w.nx * w.wum) + round32((size_t)w.NUp * w.wum) + round32(w.wxm) +
         round32(w.wum);
}

// F, the replicated buffer: [Vxx | Vx] (NXp × SA), then Wᵀ (the same), then
// Yᵀ (nx × NUp), then Quu and L (NUp × NUp each), then X and R (NUp × SA each).
__host__ __device__ inline size_t f_floats(const WDims& w) {
  return round32(max2(max2((size_t)w.NXp * w.SA, (size_t)w.nx * w.NUp),
                      max2(2 * (size_t)w.NUp * w.NUp, 2 * (size_t)w.NUp * w.SA)));
}

// Z: the Y block, then the Quu block, then the X and P blocks.
__host__ __device__ inline size_t z_floats(const WDims& w) {
  return max2(max2((size_t)w.SA * w.wum, (size_t)w.NUp * w.wum), 2 * (size_t)w.NUp * w.wxm);
}

// (32 floats of slack put the carve on 128 bytes.)
__host__ __device__ inline size_t wide_floats(const WDims& w) {
  return 32 + f_floats(w) + 2 * knot_floats(w) + (size_t)w.SA * w.wxm + z_floats(w) +
         (size_t)w.NUp * w.wxm + w.SA + 2 * w.NUp + 4;
}

__host__ __device__ inline WDims wdims(int nx, int nu, int C) {
  const Dims d = dims(nx, nu);
  const int gx = d.SA / 4, gu = d.NUp / 4;
  return WDims{nx, nu, d.NXp, d.NUp, d.SA, C, 4 * ((gx + C - 1) / C), 4 * ((gu + C - 1) / C)};
}

struct KnotBuf {
  float *A, *lxx, *B, *luu, *lx, *lu;
};

__device__ inline KnotBuf carve_knot(float* s, const WDims& w) {
  KnotBuf k;
  k.A = s; s += round32(w.nx * w.wxm);
  k.lxx = s; s += round32(w.NXp * w.wxm);
  k.B = s; s += round32(w.nx * w.wum);
  k.luu = s; s += round32(w.NUp * w.wum);
  k.lx = s; s += round32(w.wxm);
  k.lu = s;
  return k;
}

struct WSmem {
  float* F;         // replicated, see f_floats
  float* knots;     // the double buffer: knot_floats each (carve_knot)
  float* WB;        // the W block (SA × wxm, Wᵀ's rows), then Qxx's, then T's (NXp × wxm)
  float* YB;        // the Y block (SA × wum, Yᵀ's rows)       } Z
  float* QuuB;      // the Quu block (NUp × wum)                } Z
  float *XB, *PB;   // the X and P blocks (NUp × wxm each)      } Z
  float* RB;        // the R block (NUp × wxm)
  float *Qx, *Qu;   // replicated (SA, NUp)
  float* rk;        // the factor's rsqrt per pivot (NUp)
  unsigned long long* bars;  // the knot buffers' mbarriers (2)
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ inline WSmem carve_w(float* s, const WDims& w) {
  WSmem m;
  s += ((128u - (smem_addr(s) & 127u)) & 127u) / 4;  // (pointer arithmetic: s stays shared)
  m.F = s; s += f_floats(w);
  m.knots = s; s += 2 * knot_floats(w);
  m.WB = s; s += w.SA * w.wxm;
  m.YB = m.QuuB = m.XB = s;
  m.PB = s + w.NUp * w.wxm;
  s += z_floats(w);
  m.RB = s; s += w.NUp * w.wxm;
  m.Qx = s; s += w.SA;
  m.Qu = s; s += w.NUp;
  m.rk = s; s += w.NUp;
  m.bars = reinterpret_cast<unsigned long long*>(s);
  return m;
}


// Knot t's inputs, the columns this rank holds, into buffer k, by tensor
// copies (TMA; rows 16-byte aligned, as ops/riccati.py pads them): thread 0
// issues one 2-D box per array (six per knot), completing on the buffer's
// mbarrier, whose phase every thread waits for before the knot. A box is
// wxm (wum) columns wide from the block's first column, so it also brings
// the source's zero padding, a neighbour's columns that no tile reads, and
// zeros past the row's end. tA and tX index the arrays with N and with
// N + 1 knots per instance, as in stage_knot; xoff/uoff are the first column
// of the rank's x and u blocks.
// The six inputs as 2-D tensors of float rows (ldx or ldu wide), with the
// boxes one rank takes per knot: A and lxx nx rows of wxm columns, lx one
// row, B nx rows and luu nu rows of wum columns, lu one row.
struct KnotMaps {
  CUtensorMap A, lxx, lx, B, luu, lu;
};

struct KnotCopy {
  KnotBuf k;
  WDims w;
  int xoff, uoff;
  size_t tA, tX;
  const KnotMaps* maps;

  // One box per array (the box's columns past the row are zeros), the
  // bytes of all six on the buffer's mbarrier.
  __device__ __forceinline__ void box(const CUtensorMap& m, float* dst, int col, size_t row,
                                      unsigned long long* bar) const {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(&m)), "r"(smem_addr(bar)), "r"(col), "r"((int)row)
        : "memory");
  }

  __device__ void issue(unsigned long long* bar) const {
    if (threadIdx.x != 0) return;
    // the buffer's last reads (and the first fill's zeroing) came through
    // the generic proxy, before the barrier that led here
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const unsigned bytes = 4u * (w.wxm * (2 * w.nx + 1) + w.wum * (w.nx + w.nu + 1));
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_addr(bar)), "r"(bytes) : "memory");
    box(maps->A, k.A, xoff, tA * w.nx, bar);
    box(maps->lxx, k.lxx, xoff, tX * w.nx, bar);
    box(maps->lx, k.lx, xoff, tX, bar);
    box(maps->B, k.B, uoff, tA * w.nx, bar);
    box(maps->luu, k.luu, uoff, tA * w.nu, bar);
    box(maps->lu, k.lu, uoff, tA, bar);
  }
};

// Wait until the tensor copies of a buffer's j-th knot (j = 0, 1, ...) have landed.
__device__ __forceinline__ void wait_knot(unsigned long long* bar, int j) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)), "r"(j & 1) : "memory");
}

// The all-gather step: rows [0, rows) of a local block (row stride lds, w4
// float4 per row) into every CTA's F at column col (row stride ldd), through
// distributed shared memory (the CTA's own copy included).
__device__ __forceinline__ void push_block(cg::cluster_group& cl, float* F, int ldd, int col,
                                           const float* src, int lds, int rows, int w4) {
  const int C = (int)cl.num_blocks();
  for (int e = threadIdx.x; e < rows * w4; e += kThreadsW) {
    const int r = e / w4, q = 4 * (e - r * w4);
    const float4 v = ld4(src + r * lds + q);
    float* d = F + r * ldd + col + q;
    for (int c = 0; c < C; ++c) *reinterpret_cast<float4*>(cl.map_shared_rank(d, c)) = v;
  }
}

// x / d with the plain division's result: a zero numerator gives the signed
// zero (NaN where d is 0 or NaN) without dividing, so the division's slow
// path, which a zero numerator sends the whole warp to, is never taken for
// one (right-hand sides with zero entries are common).
__device__ __forceinline__ float div_rn(float x, float d) {
  const bool z = x == 0.f;
  const float q = (z ? 1.f : x) / d;
  if (!z) return q;
  const int sign = (__float_as_int(x) ^ __float_as_int(d)) & 0x80000000;
  return isnan(d) || d == 0.f ? __int_as_float(0x7fffffff) : __int_as_float(sign);
}

// Cholesky of the nu×nu matrix whose lower triangle is at L (S_ik at
// L[k·ld + i], column-major), in place, and with it the forward
// substitution L Y = R of the w right-hand sides in X (R_kc at X[k·ldx + c]),
// by panels of kPanel columns: warp 0 factors the panel's diagonal block
// (lane l on row p0 + l, the pivot's diagonal by one shuffle from its own
// lane, L_jk by shuffles); one thread per row below solves its panel row
// with the block's rsqrt per pivot (rk), and one thread per right-hand side
// its panel entries, each step an IEEE division by L_kk, as the reference;
// then all threads apply the panel to the trailing lower triangle and to
// the right-hand sides' trailing entries. The right-hand sides are so many
// more rows of the factor, and its forward substitution needs no chain of
// its own. Every entry takes its pivots' terms one fmaf at a time in
// ascending order, L_ik = S_ik·rsqrt(S_kk) and y_k = v_k / L_kk, as the
// right-looking pivot-by-pivot factor (_chol_masked) and the forward
// substitution, so a non-positive pivot gives rsqrtf's NaN or inf where the
// reference's does. The serial loops are rolled, with the row in registers
// shifted by one column per pivot (its current pivot column is always
// element 0). Returns to every thread whether any entry of L is not finite
// (one block-wide OR; the right-hand sides do not count).
__device__ __forceinline__ bool factor_blocked(float* __restrict__ L, float* __restrict__ rk,
                                               int nu, int ld, float* __restrict__ X, int ldx,
                                               int w) {
  const int tid = threadIdx.x, lane = tid & 31;
  bool bad = false;
  for (int p0 = 0; p0 < nu; p0 += kPanel) {
    const int pw = min(kPanel, nu - p0), pe = p0 + pw;
    if (tid < 32) {
      float sv[kPanel];  // sv[j] = S_{p0+lane, p0+k+j} at pivot k
#pragma unroll
      for (int q = 0; q < kPanel; ++q)
        sv[q] = q <= lane && lane < pw ? L[(p0 + q) * ld + p0 + lane] : 0.f;
#pragma unroll
      for (int k = 0; k < kPanel; ++k) {
        if (k >= pw) break;  // warp-uniform
        const float r = rsqrtf(__shfl_sync(kFull, sv[0], k));
        const float l = sv[0] * r;
        if (lane >= k && lane < pw) {
          L[(p0 + k) * ld + p0 + lane] = l;
          bad |= !isfinite(l);
        }
        if (lane == 0) rk[p0 + k] = r;
#pragma unroll
        for (int j = 1; j < kPanel - k; ++j)
          sv[j - 1] = fmaf(-l, __shfl_sync(kFull, l, k + j), sv[j]);
      }
    }
    __syncthreads();
    const bool lrow = pe + tid < nu, xrow = tid >= kPanelRows && tid < kPanelRows + w;
    if (lrow || xrow) {
      float* v = lrow ? L + pe + tid : X + tid - kPanelRows;  // the row's entry k at v[k·stride]
      const int stride = lrow ? ld : ldx;
      float sv[kPanel];  // sv[j] = the row's entry p0+k+j at pivot k
#pragma unroll
      for (int q = 0; q < kPanel; ++q) sv[q] = q < pw ? v[(p0 + q) * stride] : 0.f;
#pragma unroll
      for (int k = 0; k < kPanel; ++k) {
        if (k >= pw) break;
        const float* Lk = L + (p0 + k) * ld + p0 + k;  // L_{p0+k+j, p0+k} at Lk[j]
        const float l = lrow ? sv[0] * rk[p0 + k] : div_rn(sv[0], Lk[0]);
        v[(p0 + k) * stride] = l;
        bad |= lrow && !isfinite(l);
#pragma unroll
        for (int j = 1; j < kPanel - k; ++j) sv[j - 1] = fmaf(-l, Lk[j], sv[j]);
      }
    }
    __syncthreads();
    const int m = nu - pe;
    for (int e = tid; e < m * m; e += kThreadsW) {
      const int b = e / m, a = e - b * m;  // row pe + a, column pe + b
      if (b <= a) {
        const int i = pe + a, j = pe + b;
        float v = L[j * ld + i];
        for (int k = p0; k < pe; ++k) v = fmaf(-L[k * ld + i], L[k * ld + j], v);
        L[j * ld + i] = v;
      }
    }
    for (int e = tid; e < m * w; e += kThreadsW) {
      const int j = pe + e / w, c = e % w;  // right-hand side c's entry j
      float v = X[j * ldx + c];
      for (int k = p0; k < pe; ++k) v = fmaf(-X[k * ldx + c], L[k * ld + j], v);
      X[j * ldx + c] = v;
    }
    __syncthreads();
  }
  return __syncthreads_or(bad);
}

// X ← (Lᵀ)⁻¹ X on the w local columns of X (X[u·ldx + c]), going up by
// blocks of kPanel rows: threads c < w solve a diagonal block for column c
// (the column's rows in registers, shifted by one per step, each step one
// IEEE division by L_kk, as the reference), then all threads update the
// rows above the block, one fmaf per term. A blocked back substitution cannot keep the
// narrow solve's ascending sums without going serial again, so each row
// takes its terms in descending k.
__device__ __forceinline__ void back_blocked(const float* __restrict__ L, float* __restrict__ X,
                                             int nu, int ld, int ldx, int w) {
  const int tid = threadIdx.x;
  const int rp = w > 0 ? kThreadsW / w : 0;        // rows an update takes at once
  const int ur = w > 0 ? tid / w : rp, uc = tid - ur * w;  // this thread's row offset, column
  for (int b0 = (nu - 1) / kPanel * kPanel; b0 >= 0; b0 -= kPanel) {
    const int bw = min(kPanel, nu - b0);
    if (tid < w) {
      float y[kPanel];  // y[j] = row b0+k-j of the column at the step for row k
#pragma unroll
      for (int q = 0; q < kPanel; ++q) y[q] = q < bw ? X[(b0 + bw - 1 - q) * ldx + tid] : 0.f;
#pragma unroll
      for (int i = 0; i < kPanel; ++i) {
        const int k = bw - 1 - i;  // row b0 + k
        if (k < 0) break;
        const float xk = div_rn(y[0], L[(b0 + k) * ld + b0 + k]);
        X[(b0 + k) * ldx + tid] = xk;
#pragma unroll
        for (int j = 1; j < kPanel - i; ++j)  // L_{b0+k, b0+k-j}; rows above the block unused
          y[j - 1] = fmaf(k >= j ? -L[(b0 + k - j) * ld + b0 + k] : 0.f, xk, y[j]);
      }
    }
    __syncthreads();
    if (ur < rp) {
#pragma unroll 2
      for (int i = ur; i < b0; i += rp) {
        float v = X[i * ldx + uc];
#pragma unroll 4
        for (int k = b0 + bw - 1; k >= b0; --k) v = fmaf(-L[i * ld + k], X[k * ldx + uc], v);
        X[i * ldx + uc] = v;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreadsW, 1)
riccati_backward_wide(const float* __restrict__ lx, const float* __restrict__ lxx,
                      const float* __restrict__ reg_ptr, float pd_bump, float* __restrict__ K,
                      float* __restrict__ kff, int N, int nx, int nu, int ldx,
                      const __grid_constant__ KnotMaps maps) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const WDims w = wdims(nx, nu, C);
  const WSmem s = carve_w(smem, w);
  const int tid = threadIdx.x, SA = w.SA, NUp = w.NUp, NXp = w.NXp, wxm = w.wxm, wum = w.wum;
  const int gx = SA / 4, gu = NUp / 4;
  const int xoff = block_start(gx, C, rank), xw = block_start(gx, C, rank + 1) - xoff;
  const int uoff = block_start(gu, C, rank), uw = block_start(gu, C, rank + 1) - uoff;
  const int inst = blockIdx.x / C;
  const size_t bN = (size_t)inst * N, bN1 = bN + inst;  // this instance's knots
  const float reg = reg_ptr[inst];
  float* const F = s.F;

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (size_t e = tid; e < wide_floats(w) / 4; e += kThreadsW)
    reinterpret_cast<float4*>(smem)[e] = zero;
  __syncthreads();
  if (tid == 0) {  // one mbarrier per knot buffer, one arrival (with its bytes) per fill
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(s.bars + b))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const size_t kn = knot_floats(w);
  const auto knot_copy = [&](int tk) {
    return KnotCopy{carve_knot(s.knots + (tk & 1) * kn, w), w, xoff, uoff, bN + tk, bN1 + tk,
                    &maps};
  };
  knot_copy(N - 1).issue(s.bars + ((N - 1) & 1));
  for (int e = tid; e < nx * nx; e += kThreadsW)
    F[(e / nx) * SA + e % nx] = lxx[((bN1 + N) * nx + e / nx) * ldx + e % nx];
  for (int e = tid; e < nx; e += kThreadsW) F[e * SA + nx] = lx[(bN1 + N) * ldx + e];
  cl.sync();  // every CTA of the cluster has started
  RICCATI_STAMP_START

  for (int t = N - 1; t >= 0; --t) {
    const KnotBuf kb = carve_knot(s.knots + (t & 1) * kn, w);
    wait_knot(s.bars + (t & 1), (N - 1 - t) >> 1);  // knot t has landed
    if (t > 0) knot_copy(t - 1).issue(s.bars + ((t - 1) & 1));
    RICCATI_STAMP(0);

    // 1. W = AᵀVV on the x block and Y = BᵀVV on the u block, VV = [Vxx | Vx]
    //    (F), stored transposed (Wᵀ's, Yᵀ's rows); their Vx column gives Qx and
    //    Qu, written to every CTA.
    {
      const int rw = xw / 4, n1 = (rw + uw / 4) * gx;
      for (int it = tid; it < n1; it += kThreadsW) {
        const int rg = it / gx, j0 = 4 * (it - rg * gx);
        const bool onY = rg >= rw;
        const int r0 = 4 * (onY ? rg - rw : rg), ld = onY ? wum : wxm;
        float acc[4][4] = {};
        outer_sum(acc, (onY ? kb.B : kb.A) + r0, ld, F + j0, SA, nx);
        float* T = (onY ? s.YB : s.WB) + r0;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          st4(T + (j0 + b) * ld, acc[0][b], acc[1][b], acc[2][b], acc[3][b]);
        const int bn = nx - j0;  // the Vx column's place in the tile
        if (bn >= 0 && bn < 4) {
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int i = (onY ? uoff : xoff) + r0 + a;
            const float av = bn == 0 ? acc[a][0] : bn == 1 ? acc[a][1] : bn == 2 ? acc[a][2]
                                                                                : acc[a][3];
            const float v = (onY ? kb.lu : kb.lx)[r0 + a] + av;
            float* dst = (onY ? s.Qu : s.Qx) + i;
#pragma unroll 1
            for (int c = 0; c < C; ++c)
              if (i < (onY ? nu : nx)) *cl.map_shared_rank(dst, c) = v;
          }
        }
      }
    }
    RICCATI_STAMP(1);
    cl.sync();  // every CTA has read its VV
    RICCATI_STAMP(2);
    push_block(cl, F, SA, xoff, s.WB, wxm, nx, xw / 4);  // F = Wᵀ
    cl.sync();
    RICCATI_STAMP(3);

    // 2a. Qxx's x block: Qxx[i][j] = lxx[i][j] + Σ_k Wᵀ[k][i]·A[k][j], over the
    //     W block's place.
    {
      const int gi = NXp / 4, n2 = gi * (xw / 4);
      for (int it = tid; it < n2; it += kThreadsW) {
        const int jg = it / gi, i0 = 4 * (it - jg * gi), j0 = 4 * jg;
        float acc[4][4] = {};
        outer_sum(acc, F + i0, SA, kb.A + j0, wxm, nx);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float4 l = ld4(kb.lxx + (i0 + a) * wxm + j0);
          st4(s.WB + (i0 + a) * wxm + j0, l.x + acc[a][0], l.y + acc[a][1], l.z + acc[a][2],
              l.w + acc[a][3]);
        }
      }
    }
    RICCATI_STAMP(4);
    cl.sync();  // every CTA has read Wᵀ
    RICCATI_STAMP(5);
    push_block(cl, F, NUp, uoff, s.YB, wum, nx, uw / 4);  // F = Yᵀ
    cl.sync();
    RICCATI_STAMP(6);

    // 2b. R = [Qxuᵀ | Qu] on the x block, Qxuᵀ = Y·A (Vxx is symmetric), and
    //     Quu = luu + Y·B + λI on the u block.
    {
      const int n_r = gu * (xw / 4), n2 = n_r + gu * (uw / 4);
      for (int it = tid; it < n2; it += kThreadsW) {
        const bool onR = it < n_r;
        const int q = onR ? it : it - n_r;
        const int cg_ = q / gu, u0 = 4 * (q - cg_ * gu), c0 = 4 * cg_;
        float acc[4][4] = {};
        outer_sum(acc, F + u0, NUp, (onR ? kb.A : kb.B) + c0, onR ? wxm : wum, nx);
        if (onR) {
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              s.RB[(u0 + a) * wxm + c0 + b] =
                  xoff + c0 + b == nx ? (u0 + a < nu ? s.Qu[u0 + a] : 0.f) : acc[a][b];
        } else {
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              float v = kb.luu[(u0 + a) * wum + c0 + b] + acc[a][b];
              if (u0 + a == uoff + c0 + b) v += reg;
              s.QuuB[(u0 + a) * wum + c0 + b] = v;
            }
        }
      }
    }
    RICCATI_STAMP(7);
    cl.sync();  // every CTA has read Yᵀ
    RICCATI_STAMP(8);
    push_block(cl, F, NUp, uoff, s.QuuB, wum, NUp, uw / 4);  // F = [Quu | L]
    cl.sync();
    RICCATI_STAMP(9);

    // 3. Every CTA factors the whole Quu (the same bits, so the same bump
    //    decision everywhere), adds pd_bump·I and factors again when the factor
    //    has a non-finite entry; then solves its x block of [K | k], forms P's,
    //    and writes its columns of K_t, k_t.
    float* Quu = F;
    float* L = F + NUp * NUp;
    for (int pass = 0; pass < 2; ++pass) {
      for (int e = tid; e < nu * nu; e += kThreadsW) {
        const int k = e / nu, i = e - k * nu;
        if (i >= k) L[k * NUp + i] = Quu[i * NUp + k];
      }
      for (int e = tid; e < NUp * xw; e += kThreadsW) {
        const int u = e / xw, c = e - u * xw;
        s.XB[u * wxm + c] = u < nu ? s.RB[u * wxm + c] : 0.f;
      }
      __syncthreads();
      if (!factor_blocked(L, s.rk, nu, NUp, s.XB, wxm, xw) || pass == 1) break;  // block-uniform
      if (tid < nu) Quu[tid * NUp + tid] += pd_bump;
      __syncthreads();
    }
    RICCATI_STAMP(10);
    back_blocked(L, s.XB, nu, NUp, wxm, xw);
    RICCATI_STAMP(11);
    for (int e = tid; e < nu * xw; e += kThreadsW) {
      const int u = e / xw, c = e - u * xw;
      const float v = -s.XB[u * wxm + c];
      s.XB[u * wxm + c] = v;
      const int j = xoff + c;
      if (j < nx) K[((bN + t) * nu + u) * nx + j] = v;
      else if (j == nx) kff[(bN + t) * nu + u] = v;
    }
    __syncthreads();
    {  // P = Quu·X + R; k's column is Quu·k + Qu summed from Qu
      const int gj = xw / 4;
      for (int it = tid; it < gu * gj; it += kThreadsW) {
        const int ug = it / gj, u0 = 4 * ug, c0 = 4 * (it - ug * gj);
        float acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc[a][b] = xoff + c0 + b == nx ? s.RB[(u0 + a) * wxm + c0 + b] : 0.f;
        for (int q = 0; q < nu; ++q) {
          const float4 x = ld4(s.XB + q * wxm + c0);
          const float xb[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float qa = Quu[(u0 + a) * NUp + q];
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(qa, xb[b], acc[a][b]);
          }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int o = (u0 + a) * wxm + c0 + b;
            s.PB[o] = xoff + c0 + b == nx ? acc[a][b] : acc[a][b] + s.RB[o];
          }
      }
    }
    RICCATI_STAMP(12);
    cl.sync();  // every CTA is done with Quu and L
    RICCATI_STAMP(13);
    push_block(cl, F, SA, xoff, s.XB, wxm, NUp, xw / 4);            // F = [X | R]
    push_block(cl, F + NUp * SA, SA, xoff, s.RB, wxm, NUp, xw / 4);
    cl.sync();
    RICCATI_STAMP(14);

    // 4. T = Qxx + XᵀP + RᵀX on the x block, in place over Qxx: T[i][j] takes
    //    X[r][i]·P[r][j], then R[r][i]·X[r][j], one fmaf each, r ascending; the
    //    Vx column starts from Qx.
    {
      const int gi = NXp / 4, n4 = gi * (xw / 4);
      const float* X = F;
      const float* R = F + NUp * SA;
      for (int it = tid; it < n4; it += kThreadsW) {
        const int jg = it / gi, i0 = 4 * (it - jg * gi), j0 = 4 * jg;
        float acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc[a][b] = xoff + j0 + b == nx ? s.Qx[i0 + a] : s.WB[(i0 + a) * wxm + j0 + b];
#pragma unroll 2
        for (int r = 0; r < nu; ++r) {
          const float4 x4 = ld4(X + r * SA + i0), r4 = ld4(R + r * SA + i0);
          const float4 p4 = ld4(s.PB + r * wxm + j0), y4 = ld4(s.XB + r * wxm + j0);
          const float xi[4] = {x4.x, x4.y, x4.z, x4.w}, ri[4] = {r4.x, r4.y, r4.z, r4.w};
          const float pj[4] = {p4.x, p4.y, p4.z, p4.w}, xj[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              acc[a][b] = fmaf(xi[a], pj[b], acc[a][b]);
              acc[a][b] = fmaf(ri[a], xj[b], acc[a][b]);
            }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
          st4(s.WB + (i0 + a) * wxm + j0, acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      }
    }
    RICCATI_STAMP(15);
    cl.sync();  // every CTA is done with X and R
    RICCATI_STAMP(16);
    push_block(cl, F, SA, xoff, s.WB, wxm, nx, xw / 4);  // F = [T | Vx]
    cl.sync();  // the last access to another CTA's memory in this knot
    RICCATI_STAMP(17);

    // Vxx = ½(T + Tᵀ), in every CTA alike, a pair of 4×4 tiles (I, J), I ≤ J,
    // per thread; Vx (column nx) and the padding stay as T left them.
    {
      const int G = NXp / 4, n_pairs = G * (G + 1) / 2;
      for (int it = tid; it < n_pairs; it += kThreadsW) {
        int I = 0, p = it;
        while (p >= G - I) p -= G - I++;
        const int i0 = 4 * I, j0 = 4 * (I + p);
        float a[4][4], b[4][4];  // T's tiles (I, J) and (J, I)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 u = ld4(F + (i0 + r) * SA + j0), v = ld4(F + (j0 + r) * SA + i0);
          a[r][0] = u.x, a[r][1] = u.y, a[r][2] = u.z, a[r][3] = u.w;
          b[r][0] = v.x, b[r][1] = v.y, b[r][2] = v.z, b[r][3] = v.w;
        }
        float na[4][4], nb[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const bool in = i0 + r < nx && j0 + c < nx;
            const float v = 0.5f * (a[r][c] + b[c][r]);
            na[r][c] = in ? v : a[r][c];
            nb[c][r] = in ? v : b[c][r];
          }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          st4(F + (i0 + r) * SA + j0, na[r][0], na[r][1], na[r][2], na[r][3]);
          if (p > 0) st4(F + (j0 + r) * SA + i0, nb[r][0], nb[r][1], nb[r][2], nb[r][3]);
        }
      }
    }
    __syncthreads();
    RICCATI_STAMP(18);
  }
}

// The smallest cluster of kMinCluster, then 8 CTAs whose CTAs hold the
// working set of (nx, nu), or 0. A probe build may pin another size C,
// where it holds the working set (-DRICCATI_FORCE_CLUSTER=C:
// tools/port_riccati_phases.py --cluster C).
int wide_cluster(int nx, int nu) {
#ifdef RICCATI_FORCE_CLUSTER
  constexpr int kFirst = RICCATI_FORCE_CLUSTER, kLast = RICCATI_FORCE_CLUSTER;
#else
  constexpr int kFirst = kMinCluster, kLast = kMaxCluster;
#endif
  static_assert(kFirst >= 1 && kLast <= kMaxCluster, "a cluster of 1 to 8 CTAs");
  for (int C = kFirst; C <= kLast; C *= 2)
    if (sizeof(float) * wide_floats(wdims(nx, nu, C)) <= kMaxSmemBytes) return C;
  return 0;
}

cudaLaunchConfig_t wide_config(int C, int batch, size_t bytes, cudaStream_t st,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * batch, 1, 1);
  cfg.blockDim = dim3(kThreadsW, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (no link to libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) == cudaSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D float tensor of `rows` rows of `ld` floats, boxes of box_rows × box_cols
// (each at most 256: nx + 1 ≤ kMaxNxW + 1).
bool tensor_map(CUtensorMap* m, const float* base, int ld, size_t rows, int box_cols,
                int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dim[2] = {(cuuint64_t)ld, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)ld * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dim, stride, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The wide design on a cluster of wide_cluster(nx, nu) CTAs per instance.
// Refuses (cudaErrorInvalidValue) rows that tensor copies cannot take (ldx,
// ldu not multiples of 4 floats, an array not 16-byte aligned) and maps
// that do not encode.
int launch_wide(const float* A, const float* B, const float* lx, const float* lu,
                const float* lxx, const float* luu, const float* reg, float pd_bump, float* K,
                float* kff, int ldx, int ldu, int batch, int N, int nx, int nu,
                cudaStream_t st) {
  static_assert(kMaxNxW + 1 <= 256, "a tensor box is at most 256 wide and high");
  const int C = wide_cluster(nx, nu);
  const bool aligned = (((uintptr_t)A | (uintptr_t)B | (uintptr_t)lx | (uintptr_t)lu |
                         (uintptr_t)lxx | (uintptr_t)luu) & 15) == 0;
  if (C == 0 || !aligned || ldx < nx || ldu < nu || ldx % 4 != 0 || ldu % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const WDims w = wdims(nx, nu, C);
  KnotMaps maps;
  memset(&maps, 0, sizeof(maps));
  const size_t n = (size_t)batch;
  if (!(tensor_map(&maps.A, A, ldx, n * N * nx, w.wxm, nx) &&
        tensor_map(&maps.lxx, lxx, ldx, n * (N + 1) * nx, w.wxm, nx) &&
        tensor_map(&maps.lx, lx, ldx, n * (N + 1), w.wxm, 1) &&
        tensor_map(&maps.B, B, ldu, n * N * nx, w.wum, nx) &&
        tensor_map(&maps.luu, luu, ldu, n * N * nu, w.wum, nu) &&
        tensor_map(&maps.lu, lu, ldu, n * N, w.wum, 1)))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * wide_floats(w);
  cudaError_t e = opt_in(riccati_backward_wide, bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = wide_config(C, batch, bytes, st, &attr);
  e = cudaLaunchKernelEx(&cfg, riccati_backward_wide, lx, lxx, reg, pd_bump, K, kff, N, nx, nu,
                         ldx, maps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory per block (per CTA of the wide design's cluster) of the
// design that takes (nx, nu); -1 where none does.
long long mpc_riccati_smem_bytes(int nx, int nu) {
  if (narrow(nx, nu)) return (long long)(sizeof(float) * smem_floats(dims(nx, nu)));
  const int C = wide_cluster(nx, nu);
  return C ? (long long)(sizeof(float) * wide_floats(wdims(nx, nu, C))) : -1;
}

// Global scratch per instance (floats): none, at every size (an earlier
// wide design staged its knots in one; callers that drive both ask this).
long long mpc_riccati_scratch_floats(int nx, int nu) { return 0; }

// The CTAs per instance of the wide design at (nx, nu) (the smallest cluster
// that holds its working set), or 0 where the narrow design takes the size
// or no cluster of at most 8 holds it.
int mpc_riccati_cluster(int nx, int nu) { return narrow(nx, nu) ? 0 : wide_cluster(nx, nu); }

// cudaOccupancyMaxActiveClusters for the wide design at (nx, nu) on its
// cluster (how many such clusters the card holds at once), or minus the CUDA
// error.
int mpc_riccati_active_clusters(int nx, int nu) {
  const int C = narrow(nx, nu) ? 0 : wide_cluster(nx, nu);
  if (C == 0) return -(int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * wide_floats(wdims(nx, nu, C));
  cudaError_t e = opt_in(riccati_backward_wide, bytes);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = wide_config(C, 1, bytes, nullptr, &attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, riccati_backward_wide, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

// The wide design at any size up to its limits (the narrow design's sizes
// too), on inputs whose rows are ldx (A, lxx, lx) and ldu (B, luu, lu)
// floats apart: multiples of 4, the arrays 16-byte aligned, as
// ops/riccati.pad_rows gives them; anything else is refused
// (cudaErrorInvalidValue).
int mpc_riccati_backward_wide(const float* A, const float* B, const float* lx, const float* lu,
                              const float* lxx, const float* luu, const float* reg, float pd_bump,
                              float* K, float* kff, int ldx, int ldu, int batch, int N, int nx,
                              int nu, void* stream) {
  if (batch < 1 || N < 1 || nx < 1 || nu < 1 || nx > kMaxNxW || nu > kMaxNuW)
    return (int)cudaErrorInvalidValue;
  return launch_wide(A, B, lx, lu, lxx, luu, reg, pd_bump, K, kff, ldx, ldu, batch, N, nx, nu,
                     (cudaStream_t)stream);
}

// K (batch, N, nu, nx), kff (batch, N, nu) from A (batch, N, nx, nx),
// B (batch, N, nx, nu), lx (batch, N+1, nx), lu (batch, N, nu),
// lxx (batch, N+1, nx, nx), luu (batch, N, nu, nu) and λ (batch,), all
// row-major float32 on the device (no host read of λ); one block (narrow)
// or one cluster (wide) per instance. The wide design takes the rows as they
// are, so it refuses (cudaErrorInvalidValue) an nx or nu that is not a
// multiple of 4: pad them first and call mpc_riccati_backward_wide, as
// ops/riccati.py does. `scratch` is not read and may be null:
// the argument stays so that one caller drives this design and the earlier
// one, which took batch · mpc_riccati_scratch_floats(nx, nu) floats there.
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
  return launch_wide(A, B, lx, lu, lxx, luu, reg, pd_bump, K, kff, nx, nu, batch, N, nx, nu, st);
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
