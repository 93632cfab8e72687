// K1 — dense warp: motion-compensated prediction of every (CTU, bin) plane.
//
// Replaces the TPU Pallas kernel vvc_affine_tpu/ops/warp.py `_warp_kernel`
// (built by `_warp_pallas_fn`, entry `warp_pallas`).  Computes the same
// function as the plain version `vvc_affine_tpu_torch/ops/warp.warp_xla`:
// for each 4x4 block of each 128x128 plane, a 9x9 window of the reference
// frame at the block's integer displacement (dy, dx), every coordinate
// clamped to the frame (the reference's clamp-to-edge window correction,
// affine.cl:288-326), filtered by the VTM 6-tap separable filter of the
// block's phases (fx, fy): first pass (sum + OFF1) >> 2, second pass
// (sum + OFF2) >> 10, clip to [0, 1023] (aux_functions.cl:1121-1195).
// Reference samples must be 10-bit, as the reference encoder's are: every
// entry point that takes frames refuses others (runtime/frames.py
// `check_samples`), since the packed int16 arithmetic below needs it.
//
// What bounds it on an H100: the bytes it must move — the int16 output
// planes (32 KB per plane), the four int32 motion planes (16 KB per plane)
// and the frame once — about 80 MB, 24 us per 1080p FULL launch at
// 3.35 TB/s.  Its integer work comes close: 312 multiply-adds per 4x4
// block on the int32 pipe, which issues 64 results per clock per SM, half
// the FP32 rate (about 31 us).  And the kernel is latency-bound before it
// is either: it runs fastest at four resident blocks per SM, which caps it
// at 64 registers.  So the design cuts instructions, not only traffic.
//
// What the design does about it:
//   * Staging.  A thread block takes one 32-row strip (8x32 blocks) of one
//     CTU in a group of consecutive bins, half the bins (rounded up).  It
//     stages into shared memory, with 4-byte cp.async all in flight at
//     once, the reference region that the windows read when their
//     displacement is within MY rows and MX columns of the strip's centre
//     block in the group's first bin: RH x RW samples, each read with
//     clamped coordinates, so a staged sample is exactly the clamped sample
//     `warp_xla` reads.  The bins of a CTU move alike, so one region serves
//     the group.  A block whose window leaves the region reads global
//     memory with clamped addresses: the kernel stays exact for ANY
//     displacement, with no R-ladder and no rebased windows.  (TMA would
//     fill out-of-frame samples with zero, not the edge, so it could serve
//     interior regions only.)
//   * Two-way dot products.  The staged samples are packed in place as
//     int16 pairs, and both passes run on __dp2a_lo/hi (int16 samples or
//     intermediates times int8 taps, which lie in [-11, 63]): a 6-tap sum
//     is four dp2a against the taps shifted by the window's column parity
//     (zeros pad the shifted tap bytes), and the vertical pass packs two
//     intermediate rows per word (|tmp| < 2^14 fits int16).  Per 4x4 block:
//     200 dp2a, 5 shared loads per window row instead of 312 multiply-adds
//     and 9 loads; int32 and FP32 multiply-adds both measured slower.
//     Tensor cores do not fit: each block has its own taps, so there is no
//     shared operand, and 10-bit samples are not exact in bf16.
//   * Conflict-free window reads.  One thread per 4x4 block; a warp is a
//     row of 32 blocks, whose windows start 4 samples (2 words) apart.  A
//     packed row stores its words by parity, so the 32 lanes' reads of one
//     window column are 32 consecutive words: one wavefront per load.  The
//     vertical pass accumulates as each intermediate row pair is made.
//   * 8-row slabs that no in-frame CU of the bin covers (the `slab_active`
//     table, as in the TPU kernel) are skipped; a strip with none active
//     in any bin of the group returns before staging.

#include <cuda_runtime.h>

namespace {

constexpr int NB = 32;                       // 4x4 blocks per CTU axis
constexpr int THREADS = 256;                 // 8 block rows x 32 blocks
constexpr int STRIP = 32;                    // plane rows per thread block
constexpr int MY = 6;                        // staged margin, rows
constexpr int RH = STRIP + 5 + 2 * MY;       // staged rows (49)
constexpr int RW = 160;                      // staged columns
constexpr int MX = (RW - 128 - 5) / 2;       // staged margin, columns (13)
constexpr int MAX_GROUP = 16;                // bins per thread block, at most
constexpr int SHIFT1 = 2;                    // IF_FILTER_PREC - 4
constexpr int OFF1 = -32768;                 // -IF_INTERNAL_OFFS << SHIFT1
constexpr int SHIFT2 = 10;                   // IF_FILTER_PREC + 4
constexpr int OFF2 = 524800;                 // (1 << 9) + (IF_INTERNAL_OFFS << 6)

// LUMA_FILTER_4x4 columns 1..6 (columns 0 and 7 are zero in every phase)
__constant__ int c_bank[16 * 6] = {
      0,   0,  64,   0,   0,   0,   // phase 0
      1,  -3,  63,   4,  -2,   1,   // phase 1
      1,  -5,  62,   8,  -3,   1,   // phase 2
      2,  -8,  60,  13,  -4,   1,   // phase 3
      3, -10,  58,  17,  -5,   1,   // phase 4
      3, -11,  52,  26,  -8,   2,   // phase 5
      2,  -9,  47,  31, -10,   3,   // phase 6
      3, -11,  45,  34, -10,   3,   // phase 7
      3, -11,  40,  40, -11,   3,   // phase 8
      3, -10,  34,  45, -11,   3,   // phase 9
      3, -10,  31,  47,  -9,   2,   // phase 10
      2,  -8,  26,  52, -11,   3,   // phase 11
      1,  -5,  17,  58, -10,   3,   // phase 12
      1,  -4,  13,  60,  -8,   2,   // phase 13
      1,  -3,   8,  62,  -5,   1,   // phase 14
      1,  -2,   4,  63,  -3,   1,   // phase 15
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

constexpr int RWW = RW / 2;                  // packed words per staged row
constexpr int HW = RWW / 2;                  // words per parity class
static_assert(HW % 32 == 8, "parity classes must start 8 banks apart");

// acc + taps t (8 int8, bytes 0..7) . samples of words w0..w3 (int16 pairs)
__device__ __forceinline__ int dot8(int w0, int w1, int w2, int w3, int2 t,
                                    int acc) {
  acc = __dp2a_lo(w0, t.x, acc);
  acc = __dp2a_hi(w1, t.x, acc);
  acc = __dp2a_lo(w2, t.y, acc);
  return __dp2a_hi(w3, t.y, acc);
}

__global__ void __launch_bounds__(THREADS, 4) warp_kernel(
    short* __restrict__ out, const int* __restrict__ ref,
    const int* __restrict__ ctu_y, const int* __restrict__ ctu_x,
    const int* __restrict__ dy, const int* __restrict__ dx,
    const int* __restrict__ fx, const int* __restrict__ fy,
    const int* __restrict__ act, int fw, int fh, int n_bins, int group_bins) {
  __shared__ __align__(16) int s_reg[RH * RW];
  __shared__ int2 s_tap[16 * 3];             // [phase][shift]: 8 int8 taps

  const int n_groups = (n_bins + group_bins - 1) / group_bins;
  const int group = blockIdx.x % n_groups;
  const int strip = (blockIdx.x / n_groups) & 3;
  const int ctu = blockIdx.x / (n_groups * 4);
  const int b0 = group * group_bins, nk = min(group_bins, n_bins - b0);
  const int tid = threadIdx.x;
  const int byl = tid >> 5, bx = tid & 31;
  // every load the staging waits for, issued together: this thread's block
  // in the group's first bin (phases are 4-bit, mv & 15: the mask keeps
  // any input in the bank), the region's centre — block (4, 16) of the
  // strip in the group's first bin; the region serves every bin of the
  // group — the CTU's corner, and the strip's slabs in every bin
  const size_t mstep = (size_t)NB * NB;
  size_t m = (size_t)(ctu * n_bins + b0) * mstep + strip * (STRIP / 4) * NB
             + tid;
  int bdy = dy[m], bdx = dx[m], ph = fx[m] & 15, pv = fy[m] & 15;
  const size_t c = m - tid + 4 * NB + 16;
  const int dyc = dy[c], dxc = dx[c];
  const int oy = ctu_y[ctu] + STRIP * strip;  // the strip's first row
  const int ox = ctu_x[ctu];
  unsigned long long act_bits = 0;           // 4 bits per bin of the group
  for (int k = 0; k < nk; ++k) {
    const int* a = act + (ctu * n_bins + b0 + k) * 16 + 4 * strip;
    act_bits |= (unsigned long long)((a[0] != 0) | (a[1] != 0) << 1
                                     | (a[2] != 0) << 2 | (a[3] != 0) << 3)
                << (4 * k);
  }
  if (act_bits == 0) return;                 // output unspecified
  if (tid < 16 * 3) {                        // taps of phase p at bytes sh..
    const int p = tid / 3, sh = tid % 3;
    unsigned b[2] = {0u, 0u};
#pragma unroll
    for (int t = 0; t < 6; ++t)
      b[(sh + t) >> 2] |= (unsigned)(c_bank[6 * p + t] & 0xff)
                          << (8 * ((sh + t) & 3));
    s_tap[tid] = make_int2((int)b[0], (int)b[1]);
  }
  const int ry0 = oy + dyc - 2 - MY, rx0 = ox + dxc - 2 - MX;
  {
    const int warp = tid >> 5, lane = tid & 31;
    int xc[RW / 32];
#pragma unroll
    for (int k = 0; k < RW / 32; ++k)
      xc[k] = clampi(rx0 + lane + 32 * k, 0, fw - 1);
    for (int r = warp; r < RH; r += THREADS / 32) {
      const int* row = ref + (size_t)clampi(ry0 + r, 0, fh - 1) * fw;
#pragma unroll
      for (int k = 0; k < RW / 32; ++k) {
        cp_async4(s_reg + r * RW + lane + 32 * k, row + xc[k]);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
  }
  __syncthreads();
  // pack in place: samples 2w and 2w + 1 of a row into word w (low, high
  // half), the row's words stored by parity: [row][w & 1][w / 2]
  {
    constexpr int NW = (RH * RWW + THREADS - 1) / THREADS;
    int pk[NW];
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      const int i = tid + q * THREADS, r = i / RWW, w = i - r * RWW;
      if (i < RH * RWW) {
        const int2 v = *reinterpret_cast<const int2*>(s_reg + r * RW + 2 * w);
        pk[q] = v.x | v.y << 16;
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      const int i = tid + q * THREADS, r = i / RWW, w = i - r * RWW;
      if (i < RH * RWW) s_reg[r * RWW + (w & 1) * HW + (w >> 1)] = pk[q];
    }
  }
  __syncthreads();

  for (int k = 0; k < nk; ++k) {
    // the next bin's motion loads while this bin is filtered
    int ndy = 0, ndx = 0, nph = 0, npv = 0;
    if (k + 1 < nk) {
      ndy = dy[m + mstep];
      ndx = dx[m + mstep];
      nph = fx[m + mstep] & 15;
      npv = fy[m + mstep] & 15;
    }
    if (act_bits >> (4 * k + (byl >> 1)) & 1) {
      const int wy = 4 * byl + bdy - dyc + MY;   // window origin in region
      const int wx = 4 * bx + bdx - dxc + MX;
      const bool staged =
          wy >= 0 && wy <= RH - 9 && wx >= 0 && wx <= RW - 9;
      const int gy0 = oy + 4 * byl + bdy - 2, gx0 = ox + 4 * bx + bdx - 2;
      int acc[4][4];
#pragma unroll
      for (int o = 0; o < 4; ++o)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[o][cc] = OFF2;
      // words k0 .. k0 + 4 of the window's region row hold samples from
      // column 2 * k0 = wx - par on; the global path packs from gx0 on
      const int par = staged ? (wx & 1) : 0;
      const int2 te = s_tap[3 * ph + par];       // even columns: shift par
      const int2 to = s_tap[3 * ph + par + 1];   // odd columns: shift par+1
      const int2 ve = s_tap[3 * pv], vo = s_tap[3 * pv + 1];
      const int k0 = wx >> 1;
      const int* e0 = s_reg + wy * RWW + (k0 & 1) * HW + (k0 >> 1);
      const int* o0 = s_reg + wy * RWW + ((k0 + 1) & 1) * HW + ((k0 + 1) >> 1);
      int prev[4];
#pragma unroll
      for (int r = 0; r < 9; ++r) {
        int w[5];
        if (staged) {
          w[0] = e0[r * RWW];
          w[1] = o0[r * RWW];
          w[2] = e0[r * RWW + 1];
          w[3] = o0[r * RWW + 1];
          w[4] = e0[r * RWW + 2];
        } else {
          const int* __restrict__ src =
              ref + (size_t)clampi(gy0 + r, 0, fh - 1) * fw;
#pragma unroll
          for (int q = 0; q < 5; ++q)
            w[q] = __ldg(src + clampi(gx0 + 2 * q, 0, fw - 1))
                   | __ldg(src + clampi(gx0 + 2 * q + 1, 0, fw - 1)) << 16;
        }
        // output column cc reads words cc / 2 .. cc / 2 + 3
        int tmp[4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          tmp[cc] = dot8(w[cc >> 1], w[(cc >> 1) + 1], w[(cc >> 1) + 2],
                         w[(cc >> 1) + 3], (cc & 1) ? to : te, OFF1)
                    >> SHIFT1;
        if ((r & 1) == 0 && r < 8) {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) prev[cc] = tmp[cc];
          continue;
        }
        // intermediate rows 2kw, 2kw + 1 as one word; output row o reads
        // words o / 2 .. with taps at shift o & 1, i.e. j = kw - o / 2
        const int kw = r >> 1;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int v = r == 8 ? (tmp[cc] & 0xffff)
                               : __byte_perm(prev[cc], tmp[cc], 0x5410);
#pragma unroll
          for (int o = 0; o < 4; ++o) {
            const int j = kw - (o >> 1);
            const int2 t = (o & 1) ? vo : ve;
            if (j == 0) acc[o][cc] = __dp2a_lo(v, t.x, acc[o][cc]);
            if (j == 1) acc[o][cc] = __dp2a_hi(v, t.x, acc[o][cc]);
            if (j == 2) acc[o][cc] = __dp2a_lo(v, t.y, acc[o][cc]);
            if (j == 3 && (o & 1)) acc[o][cc] = __dp2a_hi(v, t.y, acc[o][cc]);
          }
        }
      }
      short* __restrict__ dst = out + (size_t)(ctu * n_bins + b0 + k) * 16384
                                + (STRIP * strip + 4 * byl) * 128 + 4 * bx;
#pragma unroll
      for (int o = 0; o < 4; ++o)
        *reinterpret_cast<short4*>(dst + o * 128) = make_short4(
            (short)clampi(acc[o][0] >> SHIFT2, 0, 1023),
            (short)clampi(acc[o][1] >> SHIFT2, 0, 1023),
            (short)clampi(acc[o][2] >> SHIFT2, 0, 1023),
            (short)clampi(acc[o][3] >> SHIFT2, 0, 1023));
    }
    m += mstep;
    bdy = ndy;
    bdx = ndx;
    ph = nph;
    pv = npv;
  }
}

}  // namespace

// out: int16 [n_ctu, n_bins, 128, 128]; ref: int32 [frame_h * frame_w],
// samples in [0, 1023]; ctu_y/ctu_x: int32 [n_ctu]; dy/dx/fx/fy: int32
// [n_ctu, n_bins, 32, 32]; act: int32 [n_ctu, n_bins, 16] — 8-row slabs
// with 0 are skipped and their output rows are left unspecified.  Launches
// on `stream` and returns cudaGetLastError().
extern "C" int vvc_warp(void* out, const void* ref, const void* ctu_y,
                        const void* ctu_x, const void* dy, const void* dx,
                        const void* fx, const void* fy, const void* act,
                        int frame_w, int frame_h, int n_ctu, int n_bins,
                        void* stream) {
  const int group_bins = min(MAX_GROUP, (n_bins + 1) / 2);
  if (n_ctu > 0 && n_bins > 0) {
    warp_kernel<<<n_ctu * (128 / STRIP)
                      * ((n_bins + group_bins - 1) / group_bins),
                  THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<short*>(out), static_cast<const int*>(ref),
        static_cast<const int*>(ctu_y), static_cast<const int*>(ctu_x),
        static_cast<const int*>(dy), static_cast<const int*>(dx),
        static_cast<const int*>(fx), static_cast<const int*>(fy),
        static_cast<const int*>(act), frame_w, frame_h, n_bins, group_bins);
  }
  return static_cast<int>(cudaGetLastError());
}

// The loaded kernel's registers per thread, local memory per thread (the
// stack that spills use) and static shared memory per block, into
// attrs[0..2]; returns the cudaFuncGetAttributes error code.
extern "C" int vvc_warp_attributes(int* attrs) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, warp_kernel);
  if (err == cudaSuccess) {
    attrs[0] = a.numRegs;
    attrs[1] = static_cast<int>(a.localSizeBytes);
    attrs[2] = static_cast<int>(a.sharedSizeBytes);
  }
  return static_cast<int>(err);
}
