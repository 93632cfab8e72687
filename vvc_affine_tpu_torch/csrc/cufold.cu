// CU fold: every CU's SATD and normal equations from K2's per-block sums.
//
// Replaces no TPU kernel: the JAX package's folds are XLA glue.  It was
// added because the plain version,
// `vvc_affine_tpu_torch/models/affine_plane._fold_cu_plain` (the port of
// the JAX package's `_reduce_pred` folds and `_assemble_equations`), runs
// per evaluate as a loop over the 12 or 24 CU classes: the SATD blocks
// masked and summed over each CU's slot rectangle, and every unique M and
// rhs term built as int64 planes and summed the same way, about 250 (FULL)
// and 1,000 (HALF) small int64 PyTorch ops per evaluate, half of the nodes
// a plane frame-ref's CUDA graphs replay.  This kernel computes the same
// function in one launch per evaluate, bit for bit:
//   * satd[c] = sum over CU c's slots of satd_b where the slot belongs to
//     c's class (`slot_valid`), zero where c is not in the frame;
//   * with the moments (gx*gx, gx*gy, gy*gy, gx*err, gy*err) of each slot,
//     the linear model a_p, b_p over (1, cx, cy) of the slot's sub-block
//     centre (ops/equations.py, affine.cl:680-694):
//     M[c][p][q] = sum m0 a_p a_q + m1 (a_p b_q + a_q b_p) + m2 b_p b_q and
//     rhs[c][p] = (sum m3 a_p + m4 b_p) << 3, zero where c is not in the
//     frame.  Both are linear in the six slot sums of each of m0..m2 times
//     1, cx, cy, cx*cx, cx*cy, cy*cy and the three of m3, m4 times 1, cx,
//     cy, so a thread keeps those 24 sums and the SATD sum (25), and M and
//     rhs are formed from them once per CU.
// Exactness: every sum is int64.  Block moments are below 2^29 in
// magnitude and the weights at most 126 * 126, so a CU's sums stay below
// 2^54 and no partial sum wraps, in any order: the result equals the plain
// version's, which sums other int64 terms in another order.
//
// The tables: `lanes` (`planes.fold_lane_table`, one per mode, built on
// the host with the other PlaneTables) gives per lane of a CTU the CU's
// canonical index, class, bin, first block row and height, and the lane's
// block column; a CU's lanes are its columns, consecutive and aligned to
// its width in blocks (a power of two up to 32).  `slots`
// (`planes.bin_slot_table`) gives per (bin, block) the class covering it
// and the sub-block centre cx, cy.  Neither has a CTU axis: padded tables
// and a shard's rows read the same ones.
//
// What bounds it on an H100: bytes.  It reads each in-frame CU slot's SATD
// and five moments once, 24 B (K2 wrote them; uncovered slots and CUs out
// of the frame are not read), about 150 MB per FULL and 113 MB per HALF
// evaluate at 4K, and writes 344 B per HALF 3CP CU (50 MB at 4K): some
// 50 us at 3.35 TB/s.  The tables (28 B per lane, 12 B per block) are
// shared by every CTU and stay in L1 and L2.  The integer work is about 30
// instructions per slot.
//
// What the design does about it: one thread per (CTU, lane) walks its
// column of the CU's rectangle down the rows, four rows per step, so that
// a thread has 36 loads in flight; a warp holds 32 adjacent columns, and
// where a class tiles its rows, every load of a warp is one 128-byte line.
// The lanes of a CU then add their 25 sums in a butterfly of warp shuffles
// over the CU's width only (no shared memory, no atomics: every output is
// written once, by a plain store), and each lane of the CU stores its share
// of the CU's entries.

#include <cuda_runtime.h>

namespace {

constexpr int NB = 32;
constexpr int THREADS = 256;
constexpr int WARP = 32;
constexpr int N_MOM = 5;
constexpr int STEP = 4;                      // rows per step (sbh % 4 == 0)
// rows of the lane table (planes.LANE_ROWS)
constexpr int L_CU = 0, L_CLS = 1, L_BIN = 2, L_BY0 = 3, L_BX = 4, L_SBH = 5,
              L_SBW = 6;
// rows of the block table (planes.SLOT_ROWS) read here
constexpr int S_CLS = 0, S_CX = 2, S_CY = 3;
// the sums a thread keeps: m0..m2 times the six monomials, m3, m4 times
// (1, cx, cy), the SATD
constexpr int S_M3 = 18, S_M4 = 21, S_SATD = 24, N_SUMS = 25;

// index among (1, cx, cy, cx*cx, cx*cy, cy*cy) of u_i * u_j, u = (1, cx, cy)
__host__ __device__ constexpr int mono(int i, int j) {
  return i > j ? mono(j, i) : i == 0 ? j : i == 1 ? 2 + j : 5;
}

// The coefficient of u_i in a_p and in b_p (`affine_plane._factor_planes`):
// 3CP a = (1, cx, 0, 0, cy, 0), b = (0, 0, 1, cx, 0, cy);
// 2CP a = (1, cx, 0, cy), b = (0, cy, 1, -cx).
template <int NCP>
__host__ __device__ constexpr int coef_a(int p, int i) {
  return NCP == 3 ? (p == 0 && i == 0) || (p == 1 && i == 1) ||
                        (p == 4 && i == 2)
                  : (p == 0 && i == 0) || (p == 1 && i == 1) ||
                        (p == 3 && i == 2);
}
template <int NCP>
__host__ __device__ constexpr int coef_b(int p, int i) {
  return NCP == 3 ? (p == 2 && i == 0) || (p == 3 && i == 1) ||
                        (p == 5 && i == 2)
                  : (p == 2 && i == 0) || (p == 1 && i == 2)
                        ? 1
                        : (p == 3 && i == 1) ? -1 : 0;
}

template <int NCP>
__device__ __forceinline__ long long m_entry(const long long (&s)[N_SUMS],
                                             int p, int q) {
  long long v = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int k = mono(i, j);
      const int c0 = coef_a<NCP>(p, i) * coef_a<NCP>(q, j);
      const int c1 = coef_a<NCP>(p, i) * coef_b<NCP>(q, j) +
                     coef_a<NCP>(q, i) * coef_b<NCP>(p, j);
      const int c2 = coef_b<NCP>(p, i) * coef_b<NCP>(q, j);
      if (c0) v += c0 * s[k];
      if (c1) v += c1 * s[6 + k];
      if (c2) v += c2 * s[12 + k];
    }
  }
  return v;
}

template <int NCP>
__device__ __forceinline__ long long rhs_entry(const long long (&s)[N_SUMS],
                                               int p) {
  long long v = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (coef_a<NCP>(p, i)) v += coef_a<NCP>(p, i) * s[S_M3 + i];
    if (coef_b<NCP>(p, i)) v += coef_b<NCP>(p, i) * s[S_M4 + i];
  }
  // << 3 as PyTorch's int64 shift: on the unsigned value
  return static_cast<long long>(static_cast<unsigned long long>(v) << 3);
}

// NCP 2 or 3: SATD and equations; 0: SATD only (moms_b, m_out, rhs_out
// unused)
template <int NCP>
__global__ void __launch_bounds__(THREADS)
cufold_kernel(long long* __restrict__ satd, long long* __restrict__ m_out,
              long long* __restrict__ rhs_out, const int* __restrict__ satd_b,
              const int* __restrict__ moms_b,
              const unsigned char* __restrict__ within,
              const int* __restrict__ lanes, const int* __restrict__ slots,
              int n_ctu, int n_cus, int n_bins, int n_lanes) {
  constexpr int P = 2 * NCP;
  const int g = blockIdx.x * THREADS + threadIdx.x;
  const int ctu = g / n_lanes;
  if (ctu >= n_ctu) return;                  // whole warps: n_lanes % 32 == 0
  const int lane = g - ctu * n_lanes;
  const int cu = lanes[L_CU * n_lanes + lane];
  const int sbw = lanes[L_SBW * n_lanes + lane];
  long long s[N_SUMS];
#pragma unroll
  for (int k = 0; k < N_SUMS; ++k) s[k] = 0;
  if (within[static_cast<size_t>(ctu) * n_cus + cu]) {
    const int cls = lanes[L_CLS * n_lanes + lane];
    const int bin = lanes[L_BIN * n_lanes + lane];
    const int by0 = lanes[L_BY0 * n_lanes + lane];
    const int bx = lanes[L_BX * n_lanes + lane];
    const int sbh = lanes[L_SBH * n_lanes + lane];
    const int tab = n_bins * NB * NB;        // one row of the block table
    const size_t plane = static_cast<size_t>(ctu) * n_bins + bin;
    const int* sp = satd_b + plane * NB * NB + bx;
    const int* mp = NCP ? moms_b + plane * N_MOM * NB * NB + bx : nullptr;
    const int* tp = slots + bin * NB * NB + bx;
    for (int y0 = by0 * NB; y0 < (by0 + sbh) * NB; y0 += STEP * NB) {
#pragma unroll
      for (int r = 0; r < STEP; ++r) {
        const int blk = y0 + r * NB;
        // the SATD fold's slot_valid mask: the block is of the CU's class
        if (tp[S_CLS * tab + blk] == cls) s[S_SATD] += sp[blk];
        if constexpr (NCP != 0) {
          const int cx = tp[S_CX * tab + blk];
          const int cy = tp[S_CY * tab + blk];
          const int w[6] = {1, cx, cy, cx * cx, cx * cy, cy * cy};
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const int m = mp[k * NB * NB + blk];
#pragma unroll
            for (int i = 0; i < 6; ++i)
              s[6 * k + i] += static_cast<long long>(m) * w[i];
          }
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int m = mp[(3 + k) * NB * NB + blk];
#pragma unroll
            for (int i = 0; i < 3; ++i)
              s[S_M3 + 3 * k + i] += static_cast<long long>(m) * w[i];
          }
        }
      }
    }
  }
  // the CU's lanes add their sums: a butterfly over its aligned segment
  // of sbw lanes (every lane of the CU ends with the CU's sums)
#pragma unroll
  for (int o = 1; o < WARP; o <<= 1) {
#pragma unroll
    for (int k = 0; k < N_SUMS; ++k) {
      if (NCP == 0 && k != S_SATD) continue;
      const long long v = __shfl_xor_sync(0xffffffffu, s[k], o);
      if (o < sbw) s[k] += v;
    }
  }
  // entry e of the CU (SATD, then M row-major, then rhs) is stored by the
  // CU's lane e mod sbw
  const int j = lane & (sbw - 1);
  const size_t c = static_cast<size_t>(ctu) * n_cus + cu;
  if (j == 0) satd[c] = s[S_SATD];
  if constexpr (NCP != 0) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if (((1 + p * P + q) & (sbw - 1)) == j)
          m_out[c * P * P + p * P + q] = m_entry<NCP>(s, p, q);
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (((1 + P * P + p) & (sbw - 1)) == j)
        rhs_out[c * P + p] = rhs_entry<NCP>(s, p);
    }
  }
}

template <int NCP>
cudaError_t launch(void* satd, void* m, void* rhs, const void* satd_b,
                   const void* moms_b, const void* within, const void* lanes,
                   const void* slots, int n_ctu, int n_cus, int n_bins,
                   int n_lanes, cudaStream_t stream) {
  const long long threads = static_cast<long long>(n_ctu) * n_lanes;
  const int blocks = static_cast<int>((threads + THREADS - 1) / THREADS);
  if (blocks > 0) {
    cufold_kernel<NCP><<<blocks, THREADS, 0, stream>>>(
        static_cast<long long*>(satd), static_cast<long long*>(m),
        static_cast<long long*>(rhs), static_cast<const int*>(satd_b),
        static_cast<const int*>(moms_b),
        static_cast<const unsigned char*>(within),
        static_cast<const int*>(lanes), static_cast<const int*>(slots),
        n_ctu, n_cus, n_bins, n_lanes);
  }
  return cudaGetLastError();
}

}  // namespace

// satd: int64 [n_ctu, n_cus]; m: int64 [n_ctu, n_cus, 2 n_cp, 2 n_cp] and
// rhs: int64 [n_ctu, n_cus, 2 n_cp], written only with `refine`; satd_b:
// int32 [n_ctu, n_bins, 32, 32]; moms_b: int32 [n_ctu, n_bins, 5, 32, 32],
// read only with `refine`; within: bool (one byte) [n_ctu, n_cus]; lanes:
// int32 [7, n_lanes] (planes.fold_lane_table), n_lanes a multiple of 32;
// slots: int32 [6, n_bins, 32, 32] (planes.bin_slot_table); n_cp 2 or 3.
// Launches on `stream` and returns cudaGetLastError() (cudaErrorInvalidValue
// for another n_cp or n_lanes, without launching).
extern "C" int vvc_cufold(void* satd, void* m, void* rhs, const void* satd_b,
                          const void* moms_b, const void* within,
                          const void* lanes, const void* slots, int n_ctu,
                          int n_cus, int n_bins, int n_lanes, int n_cp,
                          int refine, void* stream) {
  if ((n_cp != 2 && n_cp != 3) || n_lanes % WARP)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      !refine ? launch<0>(satd, m, rhs, satd_b, moms_b, within, lanes, slots,
                          n_ctu, n_cus, n_bins, n_lanes, st)
      : n_cp == 2
          ? launch<2>(satd, m, rhs, satd_b, moms_b, within, lanes, slots,
                      n_ctu, n_cus, n_bins, n_lanes, st)
          : launch<3>(satd, m, rhs, satd_b, moms_b, within, lanes, slots,
                      n_ctu, n_cus, n_bins, n_lanes, st);
  return static_cast<int>(err);
}

// The loaded 3CP kernel's registers per thread, local memory per thread
// and static shared memory per block, into attrs[0..2]; returns the
// cudaFuncGetAttributes error code.
extern "C" int vvc_cufold_attributes(int* attrs) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, cufold_kernel<3>);
  if (err == cudaSuccess) {
    attrs[0] = a.numRegs;
    attrs[1] = static_cast<int>(a.localSizeBytes);
    attrs[2] = static_cast<int>(a.sharedSizeBytes);
  }
  return static_cast<int>(err);
}
