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
//     < 2^25, block sums < 2^29).
// Outputs are in the folded block form the engine consumes as it is:
// satd int32 [nCtu, nBins, 32, 32], moments int32 [nCtu, nBins, 5, 32, 32].
//
// What bounds it on an H100: bytes — each plane reads 32 KB of int16
// prediction and writes 4 KB (SATD) or 24 KB (with moments); the original
// CTU (64 KB) and the per-bin border masks (64 KB) are read once per CTU and
// bin.  About 40 integer operations per sample are far below the card's
// rate.  This first version rereads the original and the masks through
// L1/L2 for every bin of a CTU.
//
// What the design does about it: one thread block per (CTU, bin); the
// prediction plane (a length-1 bin axis broadcasts, the zero-motion
// iteration) is staged once into shared memory with a zero border, so the
// replicated Sobel taps of every sample read shared memory only; one thread
// per 4x4 block keeps the 16 errors in registers for the Hadamard and the
// moment sums, and writes each result once.  No lane-resolution partials and
// no wrap-around at the plane edge, unlike the TPU kernel.

#include <cuda_runtime.h>

namespace {

constexpr int NB = 32;
constexpr int THREADS = 256;
constexpr int P = 130;                       // padded plane side
constexpr int TOP = 1, BOT = 2, LEFT = 4, RIGHT = 8;

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

// Raw Sobel of the zero-padded plane at sample (y, x); sp[y + 1][x + 1] is
// pred[y][x].
__device__ __forceinline__ void sobel(const short (*sp)[P], int y, int x,
                                      int& gx, int& gy) {
  const short* a = sp[y];
  const short* b = sp[y + 1];
  const short* c = sp[y + 2];
  gx = a[x + 2] - a[x] + 2 * b[x + 2] - 2 * b[x] + c[x + 2] - c[x];
  gy = c[x] - a[x] + 2 * c[x + 1] - 2 * a[x + 1] + c[x + 2] - a[x + 2];
}

__global__ void __launch_bounds__(THREADS) blockreduce_kernel(
    int* __restrict__ satd, int* __restrict__ moments,
    const short* __restrict__ pred, const int* __restrict__ orig,
    const int* __restrict__ border, int n_bins, int pred_bins) {
  __shared__ short sp[P][P];
  const int plane = blockIdx.x;              // ctu * n_bins + bin
  const int ctu = plane / n_bins;
  const int bin = plane % n_bins;
  const short* __restrict__ p =
      pred + (size_t)(pred_bins == 1 ? ctu : plane) * 128 * 128;
  for (int i = threadIdx.x; i < 128 * 128; i += THREADS)
    sp[(i >> 7) + 1][(i & 127) + 1] = p[i];
  for (int i = threadIdx.x; i < P; i += THREADS) {
    sp[0][i] = 0;
    sp[P - 1][i] = 0;
    sp[i][0] = 0;
    sp[i][P - 1] = 0;
  }
  __syncthreads();

  const int* __restrict__ o = orig + (size_t)ctu * 128 * 128;
  const int* __restrict__ mask = border + (size_t)bin * 128 * 128;
  for (int b = threadIdx.x; b < NB * NB; b += THREADS) {
    const int y0 = 4 * (b / NB), x0 = 4 * (b % NB);
    int d[16];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int4 ov = *reinterpret_cast<const int4*>(o + (y0 + r) * 128 + x0);
      const short* pr = sp[y0 + r + 1] + x0 + 1;
      d[4 * r + 0] = ov.x - pr[0];
      d[4 * r + 1] = ov.y - pr[1];
      d[4 * r + 2] = ov.z - pr[2];
      d[4 * r + 3] = ov.w - pr[3];
    }
    satd[(size_t)plane * NB * NB + b] = satd4x4(d);
    if (moments == nullptr) continue;

    int gxgx = 0, gxgy = 0, gygy = 0, gxe = 0, gye = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int y = y0 + k / 4, x = x0 + k % 4;
      // columns replicate the row-replicated gradients: the source column
      // is chosen by this sample's mask, the source row by that column's
      const int m = mask[y * 128 + x];
      const int xs = (m & LEFT) ? min(x + 1, 127)
                                : ((m & RIGHT) ? max(x - 1, 0) : x);
      const int m2 = mask[y * 128 + xs];
      const int ys = (m2 & TOP) ? min(y + 1, 127)
                                : ((m2 & BOT) ? max(y - 1, 0) : y);
      int gx, gy;
      sobel(sp, ys, xs, gx, gy);
      gxgx += gx * gx;
      gxgy += gx * gy;
      gygy += gy * gy;
      gxe += gx * d[k];
      gye += gy * d[k];
    }
    int* __restrict__ mo = moments + (size_t)plane * 5 * NB * NB + b;
    mo[0 * NB * NB] = gxgx;
    mo[1 * NB * NB] = gxgy;
    mo[2 * NB * NB] = gygy;
    mo[3 * NB * NB] = gxe;
    mo[4 * NB * NB] = gye;
  }
}

}  // namespace

// satd: int32 [n_ctu, n_bins, 32, 32]; moments: int32
// [n_ctu, n_bins, 5, 32, 32] or null (SATD only); pred: int16
// [n_ctu, pred_bins, 128, 128] with pred_bins 1 (broadcast) or n_bins;
// orig: int32 [n_ctu, 128, 128]; border: int32 [n_bins, 128, 128] packed
// TOP|BOT|LEFT|RIGHT CU-border bits.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int vvc_blockreduce(void* satd, void* moments, const void* pred,
                               const void* orig, const void* border,
                               int n_ctu, int n_bins, int pred_bins,
                               void* stream) {
  const int planes = n_ctu * n_bins;
  if (planes > 0) {
    blockreduce_kernel<<<planes, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<int*>(satd), static_cast<int*>(moments),
        static_cast<const short*>(pred), static_cast<const int*>(orig),
        static_cast<const int*>(border), n_bins, pred_bins);
  }
  return static_cast<int>(cudaGetLastError());
}
