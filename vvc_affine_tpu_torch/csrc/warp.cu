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
//
// What bounds it on an H100: the bytes it must move are the int16 output
// planes (32 KB per plane) plus four int32 [32, 32] motion planes (16 KB per
// plane) and the reference frame once (8.3 MB at 1080p) — about 88 MB for a
// 1080p FULL evaluate, 26 us at 3.35 TB/s; its 624 integer operations per
// block are well below that.  This first version is bound instead by load
// instructions: every block reads its 81 window samples through L1/L2 (the
// frame stays resident in the 50 MB L2), and neighbouring blocks' windows
// overlap.
//
// What the design does about it: one thread block per (CTU, bin) plane, one
// thread per 4x4 block, each window address computed from (dy, dx) with
// clamping — exact for ANY displacement, so none of the TPU kernel's
// displacement-bound machinery (R-ladder, rebased windows, escape fix-up)
// exists here.  8-row slabs that no in-frame CU of the bin covers (the
// `slab_active` table, as in the TPU kernel) are skipped.  Each window row
// is read once into registers and reused by the four horizontal taps; the
// taps come from a 16x6 bank staged in shared memory (per-thread phases
// differ, which would serialize a __constant__ read); each output row of a
// block is one 8-byte store.  Staging a CTU's union window in shared
// memory, and fusing the reduction (K3), are later work.

#include <cuda_runtime.h>

namespace {

constexpr int NB = 32;                       // 4x4 blocks per CTU axis
constexpr int THREADS = 256;
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

__global__ void __launch_bounds__(THREADS) warp_kernel(
    short* __restrict__ out, const int* __restrict__ ref,
    const int* __restrict__ ctu_y, const int* __restrict__ ctu_x,
    const int* __restrict__ dy, const int* __restrict__ dx,
    const int* __restrict__ fx, const int* __restrict__ fy,
    const int* __restrict__ act, int fw, int fh, int n_bins) {
  __shared__ int s_bank[16 * 6];
  if (threadIdx.x < 16 * 6) s_bank[threadIdx.x] = c_bank[threadIdx.x];
  __syncthreads();

  const int plane = blockIdx.x;              // ctu * n_bins + bin
  const int ctu = plane / n_bins;
  const int oy = ctu_y[ctu];
  const int ox = ctu_x[ctu];
  const size_t mbase = (size_t)plane * NB * NB;
  short* __restrict__ o = out + (size_t)plane * 128 * 128;

  for (int b = threadIdx.x; b < NB * NB; b += THREADS) {
    const int by = b / NB, bx = b % NB;
    if (act[plane * 16 + by / 2] == 0) continue;   // output unspecified
    const int y0 = oy + 4 * by + dy[mbase + b] - 2;
    const int x0 = ox + 4 * bx + dx[mbase + b] - 2;
    // phases are 4-bit (mv & 15); the mask keeps any input in the bank
    const int* hp = s_bank + 6 * (fx[mbase + b] & 15);
    const int* vp = s_bank + 6 * (fy[mbase + b] & 15);
    int hc[6], vc[6];
#pragma unroll
    for (int t = 0; t < 6; ++t) {
      hc[t] = hp[t];
      vc[t] = vp[t];
    }
    int xs[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) xs[t] = clampi(x0 + t, 0, fw - 1);

    int tmp[9][4];
#pragma unroll
    for (int r = 0; r < 9; ++r) {
      const int* row = ref + (size_t)clampi(y0 + r, 0, fh - 1) * fw;
      int w[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) w[t] = __ldg(row + xs[t]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int acc = 0;
#pragma unroll
        for (int t = 0; t < 6; ++t) acc += w[c + t] * hc[t];
        tmp[r][c] = (acc + OFF1) >> SHIFT1;  // arithmetic shift
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      int v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int acc = 0;
#pragma unroll
        for (int t = 0; t < 6; ++t) acc += tmp[r + t][c] * vc[t];
        v[c] = clampi((acc + OFF2) >> SHIFT2, 0, 1023);
      }
      *reinterpret_cast<short4*>(o + (4 * by + r) * 128 + 4 * bx) =
          make_short4((short)v[0], (short)v[1], (short)v[2], (short)v[3]);
    }
  }
}

}  // namespace

// out: int16 [n_ctu, n_bins, 128, 128]; ref: int32 [frame_h * frame_w];
// ctu_y/ctu_x: int32 [n_ctu]; dy/dx/fx/fy: int32 [n_ctu, n_bins, 32, 32];
// act: int32 [n_ctu, n_bins, 16] — 8-row slabs with 0 are skipped and their
// output rows are left unspecified.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int vvc_warp(void* out, const void* ref, const void* ctu_y,
                        const void* ctu_x, const void* dy, const void* dx,
                        const void* fx, const void* fy, const void* act,
                        int frame_w, int frame_h, int n_ctu, int n_bins,
                        void* stream) {
  const int planes = n_ctu * n_bins;
  if (planes > 0) {
    warp_kernel<<<planes, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<short*>(out), static_cast<const int*>(ref),
        static_cast<const int*>(ctu_y), static_cast<const int*>(ctu_x),
        static_cast<const int*>(dy), static_cast<const int*>(dx),
        static_cast<const int*>(fx), static_cast<const int*>(fy),
        static_cast<const int*>(act), frame_w, frame_h, n_bins);
  }
  return static_cast<int>(cudaGetLastError());
}
