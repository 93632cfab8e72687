// Motion planes: the per-block integer displacement and filter phase of
// every (CTU, bin) plane, from the canonical CPMVs, for K1.
//
// Replaces no TPU kernel.  It was added because the plain version,
// `vvc_affine_tpu_torch/models/affine_plane._mv_planes_plain` (the port of
// the JAX package's `_mv_planes`), runs as a loop over the 12 or 24 CU
// classes with about 40 small PyTorch ops each, per evaluate: about 42k of
// the ~66.5k nodes that a plane frame-ref's CUDA graphs replay, each a
// launch-sized kernel.  This kernel computes the same function in one
// launch per evaluate, bit for bit:
//   * per CU, its affine deltas (hx, hy, vx, vy) (aux_functions.cl:152-191;
//     2CP: vx = -hy, vy = hx), isSubblockVectorSpreadOverLimit
//     (aux_functions.cl:106-141) and the base (LT << 7);
//   * per 4x4 block, the MV at the block's sub-block centre (cx, cy) in the
//     CU, or at the CU centre when the spread is over the limit, rounded by
//     7 and clipped at the CU corner (aux_functions.cl:90-101);
//   * dy = mvy >> 4, dx = mvx >> 4, fx = mvx & 15, fy = mvy & 15, and zero
//     for a block that no class of the bin covers or whose CU is not in the
//     frame (affine.cl:192-208).
// Classes in a bin cover disjoint blocks, so each block has at most one
// CU: the static table `slots` (`planes.bin_slot_table`, built on the host
// with the other PlaneTables) gives per (bin, block) the class, the CU's
// canonical index in the CTU (-1: uncovered), the sub-block centre and the
// class's log2 width and height.  Nothing is indexed on the host.
//
// Bit-exactness with the plain version's int32 tensors: CPMVs reach
// +-2^17, shifted left by 7 and multiplied by centres up to 126, so sums
// and products pass 2^31.  PyTorch's int32 add, sub, mul and left shift
// wrap mod 2^32; here they are done in uint32 and cast back, which defines
// the wrap and equals it.  Right shifts of negative values are arithmetic,
// as PyTorch's are (nvcc compiles >> on int to shr.s32).
//
// What bounds it on an H100: bytes.  It writes four int32 planes, 16 B per
// block: 35 MB per HALF evaluate at 1080p (about 11 us at 3.35 TB/s) and
// 134 MB at 4K.  Its reads are small beside them: the table (20 B per
// block of one CTU's bins, shared by every CTU and held in L2) and 33 B per
// CU per CTU.  The integer work is about 60 operations per block.
//
// What the design does about it: one thread per (CTU, bin, block); a warp
// is one row of 32 blocks, so every table read and every plane write is
// one coalesced 128-byte transaction.  The threads of a CU read the same
// CPMVs, which the warp's loads merge.

#include <cuda_runtime.h>

namespace {

constexpr int NB = 32;
constexpr int THREADS = 256;                 // 8 block rows x 32 blocks
constexpr int ROWS = THREADS / NB;
constexpr int SHIFT = 7;                     // MAX_CU_DEPTH - 4 + 4
constexpr int MAX_CU = 128;
// rows of the slot table (planes.SLOT_ROWS); the class row is not read
constexpr int SLOT_CU = 1, SLOT_CX = 2, SLOT_CY = 3, SLOT_LOG2W = 4,
              SLOT_LOG2H = 5;

// int32 arithmetic that wraps as PyTorch's does
__device__ __forceinline__ int add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}
__device__ __forceinline__ int shl(int a, int s) {
  return static_cast<int>(static_cast<unsigned>(a) << s);
}
// max(0, v) - min(0, v), as ops/mv.is_spread_over_limit (INT_MIN stays)
__device__ __forceinline__ int absw(int v) { return sub(max(0, v), min(0, v)); }

// isSubblockVectorSpreadOverLimit, uni-pred branch (ops/mv.py)
__device__ __forceinline__ bool spread_over_limit(int a, int b, int c, int d) {
  constexpr int s4 = 4 << 11, tap = 6;
  int rw = (absw(add(mul(4, a), s4)) >> 11) + tap + 3;
  int rh = (absw(mul(4, b)) >> 11) + tap + 3;
  const bool spread1 = mul(rw, rh) > (tap + 9) * (tap + 5);
  rw = (absw(mul(4, c)) >> 11) + tap + 3;
  rh = (absw(add(mul(4, d), s4)) >> 11) + tap + 3;
  const bool spread2 = mul(rw, rh) > (tap + 5) * (tap + 9);
  return spread1 || spread2;
}

// roundMv by SHIFT (utils/bitmath.round_shift)
__device__ __forceinline__ int round_shift(int v) {
  return sub(add(v, 1 << (SHIFT - 1)), v >= 0 ? 1 : 0) >> SHIFT;
}

// clipMv at the CU corner pos along an axis of the frame's size (ops/mv)
__device__ __forceinline__ int clip(int v, int pos, int size) {
  const int lo = shl(-MAX_CU - 8 - pos + 1, 4);
  const int hi = shl(size + 8 - pos - 1, 4);
  return min(max(v, lo), hi);
}

__global__ void __launch_bounds__(THREADS)
mvplanes_kernel(int* __restrict__ out, const int* __restrict__ cpmvs,
                const int* __restrict__ abs_x, const int* __restrict__ abs_y,
                const unsigned char* __restrict__ within,
                const int* __restrict__ slots, int n_ctu, int n_cus,
                int n_bins, int n_cp, int frame_w, int frame_h) {
  constexpr int groups = NB / ROWS;          // thread blocks per plane
  const int plane = blockIdx.x / groups;     // ctu * n_bins + bin
  const int ctu = plane / n_bins;
  const int bin = plane - ctu * n_bins;
  const int by = (blockIdx.x % groups) * ROWS + threadIdx.x / NB;
  const int bx = threadIdx.x % NB;
  const int blk = (bin * NB + by) * NB + bx;
  const int tab = n_bins * NB * NB;          // one row of the slot table
  const int cu = slots[SLOT_CU * tab + blk];
  int dy = 0, dx = 0, fx = 0, fy = 0;
  const int c = ctu * n_cus + cu;
  if (cu >= 0 && within[c]) {
    const int* cp = cpmvs + 6 * c;           // (LT, RT, LB) x (x, y)
    const int log2w = slots[SLOT_LOG2W * tab + blk];
    const int log2h = slots[SLOT_LOG2H * tab + blk];
    const int hx = shl(sub(cp[2], cp[0]), SHIFT - log2w);
    const int hy = shl(sub(cp[3], cp[1]), SHIFT - log2w);
    int vx, vy;
    if (n_cp == 3) {
      vx = shl(sub(cp[4], cp[0]), SHIFT - log2h);
      vy = shl(sub(cp[5], cp[1]), SHIFT - log2h);
    } else {
      vx = sub(0, hy);
      vy = hx;
    }
    const bool spread = spread_over_limit(hx, hy, vx, vy);
    const int cx = spread ? 1 << (log2w - 1) : slots[SLOT_CX * tab + blk];
    const int cy = spread ? 1 << (log2h - 1) : slots[SLOT_CY * tab + blk];
    int mvx = add(add(shl(cp[0], SHIFT), mul(hx, cx)), mul(vx, cy));
    int mvy = add(add(shl(cp[1], SHIFT), mul(hy, cx)), mul(vy, cy));
    mvx = clip(round_shift(mvx), abs_x[c], frame_w);
    mvy = clip(round_shift(mvy), abs_y[c], frame_h);
    dy = mvy >> 4;
    dx = mvx >> 4;
    fx = mvx & 15;
    fy = mvy & 15;
  }
  const size_t n = static_cast<size_t>(n_ctu) * n_bins * NB * NB;
  const size_t o = static_cast<size_t>(plane) * NB * NB + by * NB + bx;
  out[o] = dy;
  out[n + o] = dx;
  out[2 * n + o] = fx;
  out[3 * n + o] = fy;
}

}  // namespace

// out: int32 [4, n_ctu, n_bins, 32, 32], the dy, dx, fx, fy planes;
// cpmvs: int32 [n_ctu, n_cus, 3, 2]; abs_x, abs_y: int32 [n_ctu, n_cus]
// CU corners; within: bool (one byte) [n_ctu, n_cus]; slots: int32
// [6, n_bins, 32, 32] (planes.bin_slot_table); n_cp 2 or 3.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int vvc_mvplanes(void* out, const void* cpmvs, const void* abs_x,
                            const void* abs_y, const void* within,
                            const void* slots, int n_ctu, int n_cus,
                            int n_bins, int n_cp, int frame_w, int frame_h,
                            void* stream) {
  const int blocks = n_ctu * n_bins * (NB / ROWS);
  if (blocks > 0) {
    mvplanes_kernel<<<blocks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<int*>(out), static_cast<const int*>(cpmvs),
        static_cast<const int*>(abs_x), static_cast<const int*>(abs_y),
        static_cast<const unsigned char*>(within),
        static_cast<const int*>(slots), n_ctu, n_cus, n_bins, n_cp, frame_w,
        frame_h);
  }
  return static_cast<int>(cudaGetLastError());
}

// The loaded kernel's registers per thread, local memory per thread and
// static shared memory per block, into attrs[0..2]; returns the
// cudaFuncGetAttributes error code.
extern "C" int vvc_mvplanes_attributes(int* attrs) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, mvplanes_kernel);
  if (err == cudaSuccess) {
    attrs[0] = a.numRegs;
    attrs[1] = static_cast<int>(a.localSizeBytes);
    attrs[2] = static_cast<int>(a.sharedSizeBytes);
  }
  return static_cast<int>(err);
}
