// K2 — block reduction: per-4x4-block SATD and normal-equation moments of
// every (CTU, bin) prediction plane.
//
// Replaces the TPU Pallas kernel vvc_affine_tpu/ops/blockreduce.py
// `_make_kernel` (built by `_reduce_fn`, entry `reduce_pallas`).  Computes
// the same function as the plain version
// `vvc_affine_tpu_torch/ops/blockreduce.reduce_blocks_plain`:
//   * err = orig - pred, and per 4x4 block the VTM Hadamard SATD with the
//     JVET_R0164 mean scaling, (sum|H| - |H00| + (|H00| >> 2) + 1) >> 1
//     (aux_functions.cl:1940-2043);
//   * with moments: the Sobel gradients gx, gy of pred (zero outside the
//     plane), with the per-CU border replication of affine.cl:472-540 in
//     the engine's order — rows first (TOP beats BOT), then columns on the
//     row-replicated gradients (LEFT beats RIGHT) — and per block the int32
//     sums of gx*gx, gx*gy, gy*gy, gx*err, gy*err (per-sample products
//     < 2^25, block sums < 2^29, so FP32 would not be exact).
// Outputs are in the folded block form the engine consumes as it is:
// satd int32 [nCtu, nBins, 32, 32], moments int32 [nCtu, nBins, 5, 32, 32].
//
// The replication: every CU of both layouts is at least 16x16 and on the
// 4-sample grid, so each 4x4 block lies in one CU and a border sample's
// source lies in its own block.  The replication of a bin therefore reduces
// to four flags per block — row 0 from row 1 (TOP), row 3 from row 2 (BOT),
// column 0 from column 1 (LEFT), column 3 from column 2 (RIGHT) — which
// `ops/blockreduce.replication_flags` derives once per PlaneTables from the
// per-sample masks (and refuses masks that do not reduce so).  The kernel
// reads one byte per block instead of two dependent mask gathers per sample.
//
// What bounds it on an H100: bytes at the data-sheet rates — each plane
// reads 32 KB of int16 prediction and writes 4 KB (SATD) or 24 KB (with
// moments), the original CTU (64 KB) is read once per CTU — about 102 MB
// and 31 us per 1080p FULL launch.  But its integer work is close behind:
// about 26 instructions per sample (SATD butterflies, Sobel, selects, five
// products) on the int32 pipe, which issues 64 results per clock per SM,
// half the FP32 rate; so the design cuts instructions as well as traffic.
// Tensor cores do not fit: the Hadamard and Sobel are adds of 10-bit
// samples with no shared operand, and the moment sums need exact int32.
//
// What the design does about it: a thread block takes one 32-row strip of
// one CTU for a group of GROUP bins.  Each thread owns one 4x4 block and
// keeps the block's 16 original samples in registers across the bins, so
// the original is read once per group, not once per bin.  The prediction
// strip (34 rows with the halo) is staged into shared memory with 16-byte
// cp.async, double-buffered: the next bin's strip loads while this bin's is
// reduced (a length-1 bin axis, the zero-motion iteration, is staged once).
// Each thread reads its 6x6 neighbourhood with three aligned loads per row
// (lanes 8 bytes apart, full bandwidth), computes gx and gy in separable
// form ([1 2 1] column and row sums shared between neighbouring samples),
// applies the block's flags as register selects, and writes each output
// once, coalesced across the warp.

#include <cuda_runtime.h>

namespace {

constexpr int NB = 32;
constexpr int THREADS = 256;                 // 8 block rows x 32 blocks
constexpr int STRIP = 32;                    // plane rows per thread block
constexpr int SROWS = STRIP + 2;             // staged rows, with the halo
constexpr int SW = 144;                      // staged row stride (int16)
constexpr int XOFF = 8;                      // plane column x at x + XOFF
constexpr int GROUP = 4;                     // bins per thread block
constexpr int TOP = 1, BOT = 2, LEFT = 4, RIGHT = 8;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ int satd4x4(const int d[16]) {
  int m[16], e[16];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    m[k] = d[k] + d[12 + k];
    m[4 + k] = d[4 + k] + d[8 + k];
    m[8 + k] = d[4 + k] - d[8 + k];
    m[12 + k] = d[k] - d[12 + k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    e[k] = m[k] + m[4 + k];
    e[4 + k] = m[8 + k] + m[12 + k];
    e[8 + k] = m[k] - m[4 + k];
    e[12 + k] = m[12 + k] - m[8 + k];
  }
#pragma unroll
  for (int b = 0; b < 16; b += 4) {
    m[b + 0] = e[b + 0] + e[b + 3];
    m[b + 1] = e[b + 1] + e[b + 2];
    m[b + 2] = e[b + 1] - e[b + 2];
    m[b + 3] = e[b + 0] - e[b + 3];
  }
#pragma unroll
  for (int b = 0; b < 16; b += 4) {
    e[b + 0] = m[b + 0] + m[b + 1];
    e[b + 1] = m[b + 0] - m[b + 1];
    e[b + 2] = m[b + 2] + m[b + 3];
    e[b + 3] = m[b + 3] - m[b + 2];
  }
  int s = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) s += abs(e[k]);
  const int a0 = abs(e[0]);
  s = s - a0 + (a0 >> 2);
  return (s + 1) >> 1;
}

// Stage the strip's rows of prediction plane `src` (halo included) into
// `dst`; rows outside the plane are left as the zero rows written at start.
__device__ __forceinline__ void stage(short* dst, const short* src,
                                     int strip) {
  for (int i = threadIdx.x; i < SROWS * 16; i += THREADS) {
    const int r = i >> 4, c = i & 15;
    const int y = strip * STRIP - 1 + r;
    if (y >= 0 && y < 128)
      cp_async16(dst + r * SW + XOFF + 8 * c, src + y * 128 + 8 * c);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(THREADS, 2) blockreduce_kernel(
    int* __restrict__ satd, int* __restrict__ moments,
    const short* __restrict__ pred, const int* __restrict__ orig,
    const unsigned char* __restrict__ repl, int n_bins, int pred_bins) {
  __shared__ __align__(16) short sp[2][SROWS * SW];
  const int n_groups = (n_bins + GROUP - 1) / GROUP;
  const int group = blockIdx.x % n_groups;
  const int strip = (blockIdx.x / n_groups) % (128 / STRIP);
  const int ctu = blockIdx.x / (n_groups * (128 / STRIP));
  const int b0 = group * GROUP;
  const int nk = min(GROUP, n_bins - b0);
  const bool bcast = pred_bins == 1;

  // zero the border columns x = -1 and x = 128 (with their unused pair
  // halves) of both buffers, and the halo row outside the plane
  for (int i = threadIdx.x; i < 2 * SROWS; i += THREADS) {
    short* row = sp[i / SROWS] + (i % SROWS) * SW;
    *reinterpret_cast<int*>(row + XOFF - 2) = 0;
    *reinterpret_cast<int*>(row + XOFF + 128) = 0;
  }
  if (strip == 0 || strip == 128 / STRIP - 1) {
    const int r = strip == 0 ? 0 : SROWS - 1;
    for (int i = threadIdx.x; i < 2 * 16; i += THREADS)
      *reinterpret_cast<int4*>(sp[i / 16] + r * SW + XOFF + 8 * (i % 16)) =
          make_int4(0, 0, 0, 0);
  }

  const short* __restrict__ pbase = pred + (size_t)ctu * pred_bins * 16384;
  stage(sp[0], pbase + (bcast ? 0 : (size_t)b0 * 16384), strip);

  const int bry = threadIdx.x >> 5, bx = threadIdx.x & 31;
  const int by = strip * (STRIP / 4) + bry;
  const int x0 = 4 * bx;
  int o[16];
  {
    const int* __restrict__ op = orig + (size_t)ctu * 16384 + 4 * by * 128
                                 + x0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(op + r * 128));
      o[4 * r + 0] = v.x;
      o[4 * r + 1] = v.y;
      o[4 * r + 2] = v.z;
      o[4 * r + 3] = v.w;
    }
  }

  for (int k = 0; k < nk; ++k) {
    const int b = b0 + k;
    const short* buf = sp[bcast ? 0 : (k & 1)];
    if (!bcast && k + 1 < nk) {
      stage(sp[(k + 1) & 1], pbase + (size_t)(b + 1) * 16384, strip);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const size_t plane = (size_t)ctu * n_bins + b;
    const int slot = by * NB + bx;
    // p[r][c]: pred at plane row 4*by - 1 + r, column x0 - 1 + c
    int p[6][6];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      const short* row = buf + (4 * bry + r) * SW + XOFF + x0;
      const int a = *reinterpret_cast<const int*>(row - 2);
      const int2 m = *reinterpret_cast<const int2*>(row);
      const int c = *reinterpret_cast<const int*>(row + 4);
      p[r][0] = a >> 16;
      p[r][1] = static_cast<short>(m.x);
      p[r][2] = m.x >> 16;
      p[r][3] = static_cast<short>(m.y);
      p[r][4] = m.y >> 16;
      p[r][5] = static_cast<short>(c);
    }
    int d[16];
#pragma unroll
    for (int k2 = 0; k2 < 16; ++k2)
      d[k2] = o[k2] - p[k2 / 4 + 1][k2 % 4 + 1];
    satd[plane * NB * NB + slot] = satd4x4(d);

    if (moments != nullptr) {
      // [1 2 1] column sums V (for gx) and row sums H (for gy)
      int v[4][6], h[6][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 6; ++c)
          v[r][c] = p[r][c] + 2 * p[r + 1][c] + p[r + 2][c];
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          h[r][c] = p[r][c] + 2 * p[r][c + 1] + p[r][c + 2];
      int gx[4][4], gy[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          gx[r][c] = v[r][c + 2] - v[r][c];
          gy[r][c] = h[r + 2][c] - h[r][c];
        }
      const int f = repl[(size_t)b * NB * NB + slot];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        gx[0][c] = (f & TOP) ? gx[1][c] : gx[0][c];
        gy[0][c] = (f & TOP) ? gy[1][c] : gy[0][c];
        gx[3][c] = (f & BOT) ? gx[2][c] : gx[3][c];
        gy[3][c] = (f & BOT) ? gy[2][c] : gy[3][c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        gx[r][0] = (f & LEFT) ? gx[r][1] : gx[r][0];
        gy[r][0] = (f & LEFT) ? gy[r][1] : gy[r][0];
        gx[r][3] = (f & RIGHT) ? gx[r][2] : gx[r][3];
        gy[r][3] = (f & RIGHT) ? gy[r][2] : gy[r][3];
      }
      int gxgx = 0, gxgy = 0, gygy = 0, gxe = 0, gye = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int x = gx[r][c], y = gy[r][c], e = d[4 * r + c];
          gxgx += x * x;
          gxgy += x * y;
          gygy += y * y;
          gxe += x * e;
          gye += y * e;
        }
      int* __restrict__ mo = moments + plane * 5 * NB * NB + slot;
      mo[0 * NB * NB] = gxgx;
      mo[1 * NB * NB] = gxgy;
      mo[2 * NB * NB] = gygy;
      mo[3 * NB * NB] = gxe;
      mo[4 * NB * NB] = gye;
    }
    __syncthreads();      // the buffer is restaged two bins later
  }
}

}  // namespace

// satd: int32 [n_ctu, n_bins, 32, 32]; moments: int32
// [n_ctu, n_bins, 5, 32, 32] or null (SATD only); pred: int16
// [n_ctu, pred_bins, 128, 128] with pred_bins 1 (broadcast) or n_bins;
// orig: int32 [n_ctu, 128, 128]; repl: uint8 [n_bins, 32, 32] per-block
// replication flags TOP|BOT|LEFT|RIGHT.  pred and orig 16-byte aligned.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int vvc_blockreduce(void* satd, void* moments, const void* pred,
                               const void* orig, const void* repl,
                               int n_ctu, int n_bins, int pred_bins,
                               void* stream) {
  const int blocks = n_ctu * (128 / STRIP) * ((n_bins + GROUP - 1) / GROUP);
  if (blocks > 0) {
    blockreduce_kernel<<<blocks, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<int*>(satd), static_cast<int*>(moments),
        static_cast<const short*>(pred), static_cast<const int*>(orig),
        static_cast<const unsigned char*>(repl), n_bins, pred_bins);
  }
  return static_cast<int>(cudaGetLastError());
}

// The loaded kernel's registers per thread, local memory per thread (the
// stack that spills use) and static shared memory per block, into
// attrs[0..2]; returns the cudaFuncGetAttributes error code.
extern "C" int vvc_blockreduce_attributes(int* attrs) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, blockreduce_kernel);
  if (err == cudaSuccess) {
    attrs[0] = a.numRegs;
    attrs[1] = static_cast<int>(a.localSizeBytes);
    attrs[2] = static_cast<int>(a.sharedSizeBytes);
  }
  return static_cast<int>(err);
}
